"""Replay memory: the uniform path of cartpoleplusplus_tpu.replay."""
