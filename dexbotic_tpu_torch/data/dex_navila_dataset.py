"""NaVILA dataset: video-frame conversations with a uniform frame history
(port of dexbotic_tpu/data/dex_navila_dataset.py; host-side numpy).

Each sample is the current frame of an episode plus a uniformly sampled
history of its earlier frames (images, or frames of the episode's video),
fed as a multi-image conversation: one ``<image>`` tag a frame, then the
prompt; the answer is the navigation text.
"""

from __future__ import annotations

import os
import random

import numpy as np

from dexbotic_tpu_torch.data.dexdata import DexDataset, load_jsonl
from dexbotic_tpu_torch.data.multimodal import load_image, load_video_frames


class DexNavilaDataset(DexDataset):
    def __init__(self, *args, num_video_frames: int = 8, **kw):
        kw.setdefault("num_images", num_video_frames)
        super().__init__(*args, **kw)
        self.num_video_frames = num_video_frames
        self._length_hints = None

    def length_hints(self) -> list[int]:
        """A cheap length of each sample (the prompt's and the answer's
        characters) for the length-grouped schedule: every sample has the
        same image tokens, so the text orders the lengths."""
        if self._length_hints is None:
            per_file: dict[int, list[int]] = {}
            hints = []
            for _, file_idx, frame_idx in self.global_index:
                if file_idx not in per_file:
                    episode = load_jsonl(self.file_name_map[file_idx], parse=True)
                    per_file[file_idx] = [len(str(fr.get("prompt", ""))) + len(str(fr.get("answer", "")))
                                          for fr in episode]
                lens = per_file[file_idx]
                hints.append(lens[min(frame_idx, len(lens) - 1)] if lens else 0)
            self._length_hints = hints
        return self._length_hints

    def _history_indices(self, t: int) -> list[int]:
        """Frames 0..t sampled uniformly into num_video_frames slots; a short
        episode is padded with the current frame."""
        n = self.num_video_frames
        if t + 1 <= n:
            return list(range(t + 1)) + [t] * (n - t - 1)
        return np.linspace(0, t, n).round().astype(int).tolist()

    def unsafe_getitem(self, idx) -> dict:
        ds_idx, file_idx, frame_idx = self.global_index[idx]
        episode = load_jsonl(self.file_name_map[file_idx], parse=True)
        if frame_idx >= len(episode):
            frame_idx = random.randint(0, len(episode) - 1)
        hist = self._history_indices(frame_idx)
        cur = episode[frame_idx]
        prefix = self.dataset_map[ds_idx]["data_path_prefix"]

        frames, video_cache = [], {}
        for t in hist:
            ref = episode[t].get("images_1") or episode[t].get("image")
            url = os.path.join(prefix, ref["url"])
            if ref["type"] == "video":
                if url not in video_cache:
                    wanted = sorted({int(episode[h]["images_1"]["frame_idx"]) for h in hist
                                     if (episode[h].get("images_1") or {}).get("type") == "video"})
                    video_cache[url] = load_video_frames(url, wanted)
                frames.append(video_cache[url][int(ref["frame_idx"])])
            else:
                frames.append(load_image(url))
        out = {"image": np.stack([self.image_process_func[0](f) for f in frames], axis=0)}

        image_tags = "<image>\n" * self.num_video_frames
        conversations = [{"from": "human", "value": f"{image_tags}{cur.get('prompt', '')}"},
                         {"from": "gpt", "value": cur.get("answer", "")}]
        tok = self.tokenization_func(conversations=conversations, has_image=True)
        out["input_ids"] = tok["input_ids"]
        out["labels"] = tok["labels"]
        return out
