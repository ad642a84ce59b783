"""Simulator environment wrappers for RL rollouts (port of dexbotic_tpu/sim_envs)."""
