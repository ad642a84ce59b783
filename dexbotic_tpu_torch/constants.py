"""Framework-wide constants.

Mirrors the reference's token sentinels (/root/reference/dexbotic/constants.py:1-3)
so converted datasets and tokenized streams are interchangeable.
"""

# Label value ignored by the cross-entropy loss (masked instruction spans).
IGNORE_INDEX = -100

# Placeholder id spliced into input_ids wherever an image's vision tokens go.
IMAGE_TOKEN_INDEX = -200

# Literal tag used in raw prompt text, expanded at tokenization time.
DEFAULT_IMAGE_TOKEN = "<image>"

# Large negative value used for additive attention bias (same constant the
# reference uses, /root/reference/dexbotic/model/pi0/pi0_arch.py:32).
MASKED_BIAS = -2.3819763e38
