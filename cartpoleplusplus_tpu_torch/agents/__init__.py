"""Agent wiring: vector-env construction, greedy evaluation, DDPG acting."""
