"""Batch collation to static device shapes.

Functional surface of the reference collator (/root/reference/dexbotic/data/
collator.py) — pad input_ids/labels, derive attention_mask, stack mapped
extra keys — but padding to a FIXED max_length so XLA sees one shape
(recompile-free training), and attention_mask built from true lengths (no
eos<->pad sentinel swap needed).
"""

from __future__ import annotations

import numpy as np

from dexbotic_tpu_torch.constants import IGNORE_INDEX

MAPPING_KEYS = {
    "image": "images",
    "actions": "actions",
    "action": "actions",
    "state": "states",
    "reward": "reward",
    "image_masks": "image_masks",
    "has_action": "has_action",
    "has_text": "has_text",
    "indexes": "indexes",
}


class Collator:
    def __init__(self, pad_token_id: int, max_length: int):
        self.pad_token_id = pad_token_id
        self.max_length = max_length

    def __call__(self, instances: list[dict]) -> dict[str, np.ndarray]:
        B = len(instances)
        L = self.max_length
        input_ids = np.full((B, L), self.pad_token_id, np.int64)
        labels = np.full((B, L), IGNORE_INDEX, np.int64)
        attention_mask = np.zeros((B, L), bool)
        for i, inst in enumerate(instances):
            ids = np.asarray(inst["input_ids"])[:L]
            lab = np.asarray(inst["labels"])[:L]
            input_ids[i, : len(ids)] = ids
            labels[i, : len(lab)] = lab
            if "token_mask" in inst:
                # fixed-length tokenizations (Pi0/DM0) arrive pre-padded;
                # their token_mask marks the REAL tokens (process.py:130-245)
                tm = np.asarray(inst["token_mask"])[:L]
                attention_mask[i, : len(tm)] = tm.astype(bool)
            else:
                attention_mask[i, : len(ids)] = True

        batch = {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": attention_mask,
        }
        for key, out_key in MAPPING_KEYS.items():
            if key in instances[0] and out_key not in batch:
                vals = [np.asarray(inst[key]) for inst in instances]
                if all(v is not None and v.shape == vals[0].shape for v in vals):
                    batch[out_key] = np.stack(vals)
                else:
                    batch[out_key] = vals
        return batch
