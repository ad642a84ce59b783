"""ManiSkill2 recipes of the ported policies: CogACT, OFT and pi0."""
