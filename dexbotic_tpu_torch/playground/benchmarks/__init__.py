"""Benchmark recipes of the port: LIBERO, CALVIN, ManiSkill2, RoboTwin2.0 and SimplerEnv."""
