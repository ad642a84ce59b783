"""RoboTwin2.0 recipe of the ported CogACT."""
