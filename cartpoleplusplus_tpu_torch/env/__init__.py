"""Environment layer: batched functional cartpole++ env and vector env."""
