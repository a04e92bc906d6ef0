"""Policy networks (the DDPG actor and its pixel encoder)."""
