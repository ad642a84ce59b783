"""Episode-dict transform pipeline (host-side, numpy).

Semantics pinned to the reference transforms
(/root/reference/dexbotic/data/dataset/transform/{common,action,language}.py):
episodes flow through as dicts of per-frame arrays/lists with a `meta_data`
side channel; each transform mutates/extends the dict.
"""

from __future__ import annotations

import copy
from itertools import zip_longest

import numpy as np

DEFAULT_PROMPT_TEMPLATE = "<image>\nWhat action should the robot take to {prompt}?"


class Pipeline:
    def __init__(self, transforms: list):
        self.transforms = []
        for t in transforms:
            self.add(t)

    def __call__(self, episode: dict, **kw):
        for t in self.transforms:
            episode = t(episode, **kw)
        return episode

    def add(self, transform) -> None:
        if isinstance(transform, list):
            for t in transform:
                self.add(t)
            return
        self.transforms.append(transform)
        # hoist pipeline-level attributes (common.py:85-104)
        if hasattr(transform, "predict_length"):
            self.predict_length = transform.predict_length
        if hasattr(transform, "statistic_mapping"):
            self.statistic_mapping = transform.statistic_mapping


class ToDict:
    """Frame list -> episode dict (+meta_data)."""

    def __call__(self, frames: list, meta_data: dict | None = None, **kw) -> dict:
        ep = {k: [f[k] for f in frames] for k in frames[0].keys()}
        ep["meta_data"] = meta_data or {}
        return ep


class ToList:
    """Episode dict -> frame list (inverse of ToDict)."""

    def __init__(self, select_frame: bool = False):
        self.select_frame = select_frame

    def __call__(self, episode: dict, **kw):
        meta = episode.pop("meta_data", None)
        length = len(episode.get("prompt") or episode.get("conversations"))
        frames = [{k: v[i] for k, v in episode.items()} for i in range(length)]
        if self.select_frame:
            return frames[meta["frame_indices"][0]]
        return frames


class ToNumpy:
    """Recursively convert numeric leaves to numpy arrays, keep strings."""

    def __call__(self, data, **kw):
        if isinstance(data, dict):
            return {k: self(v) for k, v in data.items()}
        if isinstance(data, list):
            if all(isinstance(x, (int, float, bool, complex, np.number)) for x in data):
                return np.array(data)
            out = [self(x) for x in data]
            if out and all(isinstance(x, np.ndarray) for x in out):
                try:
                    return np.stack(out)
                except ValueError:
                    return out
            return out
        if isinstance(data, (int, float, bool, complex, np.number)):
            return np.array(data)
        return data


class ExtractKeys:
    def __init__(self, keys: list[str] | None = None):
        self.keys = keys

    def __call__(self, episode: dict, keys: list[str] | None = None, **kw):
        keys = keys or self.keys
        for k in keys:
            assert k in episode, f"{k} missing from episode {episode.get('meta_data')}"
        return {k: episode[k] for k in keys}


class PadState:
    def __init__(self, ndim: int = 32, axis: int = -1):
        self.ndim, self.axis = ndim, axis

    def __call__(self, episode: dict, **kw):
        if "state" not in episode:
            return episode
        s = episode["state"]
        if s.shape[self.axis] < self.ndim:
            pad = [(0, 0)] * s.ndim
            pad[self.axis] = (0, self.ndim - s.shape[self.axis])
            episode["state"] = np.pad(s, pad)
        return episode


class PadAction:
    def __init__(self, ndim: int = 32, axis: int = -1):
        self.ndim, self.axis = ndim, axis

    def __call__(self, episode: dict, **kw):
        if "action" not in episode:
            return episode
        a = episode["action"]
        if a.shape[self.axis] < self.ndim:
            pad = [(0, 0)] * a.ndim
            pad[self.axis] = (0, self.ndim - a.shape[self.axis])
            episode["action"] = np.pad(a, pad)
        return episode


class AddAction:
    """action[t] = state[t + predict_length]; truncates all keys to match."""

    def __init__(self, predict_length: int = 1):
        self.predict_length = predict_length

    def __call__(self, episode: dict, **kw):
        if "state" not in episode:
            return episode
        action = episode["state"][self.predict_length :]
        episode["action"] = action
        episode["abs_action"] = action
        for k in list(episode.keys()):
            if k == "meta_data":
                continue
            episode[k] = episode[k][: len(action)]
        return episode


class DeltaAction:
    """action <- action - state, with non-delta dims kept absolute and
    periodic dims wrapped into (-range/2, range/2]."""

    def __init__(self, enable: bool = False):
        self.enable = enable

    def __call__(self, episode: dict, **kw):
        if not self.enable or "state" not in episode or "action" not in episode:
            return episode
        meta = episode["meta_data"]
        non_delta = meta.get("non_delta_mask")
        periodic = meta.get("periodic_mask")
        prange = meta.get("periodic_range")

        state, action = episode["state"], episode["action"]
        if action.ndim == state.ndim:
            delta = action - state
        elif action.ndim == state.ndim + 1:
            delta = action - state[..., None, :]
        else:
            raise ValueError(f"action ndim {action.ndim} vs state ndim {state.ndim}")

        if periodic is not None:
            for dim in periodic:
                d = delta[..., dim]
                d = np.where(d > prange / 2, d - prange, d)
                d = np.where(d < -prange / 2, d + prange, d)
                delta[..., dim] = d
        if non_delta is not None:
            delta[..., non_delta] = action[..., non_delta]
        episode["delta_action"] = delta
        episode["action"] = delta
        return episode


class AddTrajectory:
    """action[t] <- chunk action[t : t+T] (padded 'last' or 'zero'),
    flattened to [N, T*D] when flatten=True."""

    def __init__(
        self,
        trajectory_length: int = 10,
        flatten: bool = True,
        padding_mode: str = "last",
        padding_action: bool = False,
    ):
        assert padding_mode in ("last", "zero")
        self.trajectory_length = trajectory_length
        self.flatten = flatten
        self.padding_mode = padding_mode
        self.padding_action = padding_action

    def _pad(self, action, length, non_delta):
        if len(action) >= length:
            return action
        if self.padding_mode == "zero":
            pad = np.zeros_like(action[-1])
            if non_delta is not None:
                pad[non_delta] = action[-1][non_delta]
        else:
            pad = action[-1]
        tail = np.stack([np.copy(pad) for _ in range(length - len(action))])
        return np.concatenate([action, tail], axis=0)

    def __call__(self, episode: dict, **kw):
        if "action" not in episode:
            return episode
        meta = episode["meta_data"]
        meta["trajectory_length"] = self.trajectory_length
        non_delta = meta.get("non_delta_mask")

        action = episode["action"]
        valid_len = len(action)
        if self.padding_action:
            action = self._pad(action, self.trajectory_length, non_delta)
        else:
            assert len(action) >= self.trajectory_length, (
                f"episode shorter than trajectory length: {meta}"
            )
        chunks = [action]
        for i in range(1, self.trajectory_length):
            nxt = self._pad(np.copy(action[i:]), len(action), non_delta)
            chunks.append(nxt)
        traj = np.stack(chunks, axis=-1)  # [N, D, T]
        traj = np.transpose(traj, (0, 2, 1))  # [N, T, D]
        if self.flatten:
            traj = traj.reshape(traj.shape[0], -1)
        traj = traj[:valid_len]
        episode["trajectory"] = traj
        episode["action"] = traj
        return episode


class ActionNorm:
    """Normalize keys by min/max quantiles (to [-1,1]) or mean/std."""

    def __init__(
        self,
        statistic_mapping: dict | None = None,
        strict: bool = True,
        use_quantiles: bool = False,
    ):
        self.statistic_mapping = statistic_mapping or {"default": {"min": -1, "max": 1}}
        self.strict = strict
        self.use_quantiles = use_quantiles

    def _normalize(self, data, stats):
        if self.use_quantiles:
            lo, hi = np.asarray(stats["min"]), np.asarray(stats["max"])
            return ((data - lo) / (hi - lo + 1e-6) * 2.0 - 1.0).astype(np.float32)
        return ((data - np.asarray(stats["mean"])) / (np.asarray(stats["std"]) + 1e-6)).astype(
            np.float32
        )

    def __call__(self, episode: dict, **kw):
        for key, stats in self.statistic_mapping.items():
            if key == "default":
                continue
            if key not in episode:
                if self.strict:
                    raise KeyError(f"{key} not in episode for ActionNorm")
                continue
            episode[key] = self._normalize(episode[key], stats)
        return episode


def _resolve_stats(statistic_mapping: dict, dataset: str, prompt: str) -> dict:
    if dataset not in statistic_mapping:
        return copy.deepcopy(statistic_mapping["default"])
    if prompt not in statistic_mapping[dataset]:
        return copy.deepcopy(statistic_mapping[dataset]["default"])
    return copy.deepcopy(statistic_mapping[dataset][prompt])


class ActionNormAnd2String:
    """min/max-normalize to [-1,1], discretize to vocab bins, format answer
    string (one token per dim, ' {value}')."""

    def __init__(
        self,
        statistic_mapping: dict | None = None,
        vocab_size: int = 255,
        string_format: str = " {value}",
        add_answer: bool = True,
    ):
        self.statistic_mapping = statistic_mapping or {"default": {"min": -1, "max": 1}}
        assert "default" in self.statistic_mapping
        self.vocab_size = vocab_size
        self.string_format = string_format
        self.add_answer = add_answer

    def __call__(self, episode: dict, **kw):
        if "action" not in episode:
            return episode
        action = episode["action"]
        prompt = episode["prompt"][0]
        dataset = episode["meta_data"].get("dataset", "")
        stats = _resolve_stats(self.statistic_mapping, dataset, prompt)

        lo, hi = stats["min"], stats["max"]
        if isinstance(lo, (int, float)):
            lo, hi = [lo], [hi]
        lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
        if lo.size == 1:
            lo = np.repeat(lo, action.shape[-1])
            hi = np.repeat(hi, action.shape[-1])
        if "trajectory" in episode:
            t = episode["meta_data"]["trajectory_length"]
            if lo.size * t == action.shape[-1]:
                lo = np.tile(lo, t)
                hi = np.tile(hi, t)

        lo_r, hi_r = lo.reshape(1, -1), hi.reshape(1, -1)
        a = np.clip(action, lo_r, hi_r)
        a = (a - lo_r) / (hi_r - lo_r + 1e-8) * 2 - 1
        episode["action"] = a

        if self.add_answer and "answer" not in episode:
            bins = np.clip(
                np.round((a + 1) / 2 * (self.vocab_size - 1)), 0, self.vocab_size - 1
            )
            episode["answer"] = [
                "".join(self.string_format.format(value=int(v)) for v in np.ravel(bins[i]))
                for i in range(len(bins))
            ]
        return episode


class AddPromptTemplate:
    def __init__(self, prompt_template: str = DEFAULT_PROMPT_TEMPLATE):
        self.prompt_template = prompt_template

    def __call__(self, episode: dict, **kw):
        if "is_robot" in episode and episode["is_robot"][0]:
            episode["prompt"] = [
                self.prompt_template.format(prompt=p) for p in episode["prompt"]
            ]
        return episode


class ReplaceAnswer:
    def __init__(self, default_answer: str = " ", replace_existing: bool = False):
        self.default_answer = default_answer
        self.replace_existing = replace_existing

    def __call__(self, episode: dict, **kw):
        length = episode.get("prompt") or episode.get("conversations")
        if length is None:
            raise ValueError("cannot determine episode length (no prompt/conversations)")
        if self.replace_existing or (
            "conversations" not in episode and "answer" not in episode
        ):
            episode["answer"] = [self.default_answer] * len(length)
            episode["has_text"] = np.zeros((len(length), 1), dtype=bool)
        return episode


class ToConversation:
    def __call__(self, episode: dict, **kw):
        if "conversations" in episode:
            return episode
        prompts = episode.pop("prompt", [])
        answers = episode.pop("answer", [])
        episode["conversations"] = [
            [{"from": "human", "value": p}, {"from": "gpt", "value": a}]
            for p, a in zip_longest(prompts, answers, fillvalue="")
        ]
        return episode


class AddActionFlag:
    def __init__(self, empty_action_value: np.ndarray, enable: bool = True):
        self.empty_action_value = empty_action_value
        self.enable = enable

    def __call__(self, episode: dict, **kw):
        if not self.enable:
            return episode
        episode["has_action"] = np.ones((1,), dtype=bool)
        if "action" not in episode:
            episode["action"] = np.zeros_like(self.empty_action_value)
            episode["has_action"] = np.zeros((1,), dtype=bool)
        return episode


class AddTextFlag:
    def __init__(self, enable: bool = True):
        self.enable = enable

    def __call__(self, episode: dict, **kw):
        if self.enable and "has_text" not in episode:
            episode["has_text"] = np.ones((1,), dtype=bool)
        return episode


# ---------------------------------------------------------------------------
# Output / inverse transforms (serving-side; transform/output.py)
# ---------------------------------------------------------------------------


class ActionDenorm:
    """[-1,1] -> robot units by min/max (inverse of quantile ActionNorm)."""

    def __init__(self, statistic_mapping: dict):
        self.statistic_mapping = statistic_mapping

    def __call__(self, data: dict, **kw):
        stats = self.statistic_mapping["default"]
        lo = np.asarray(stats["min"]).reshape(1, -1)
        hi = np.asarray(stats["max"]).reshape(1, -1)
        a = np.clip(data["action"], -1, 1)
        d = a.shape[-1]
        data["action"] = lo[:, :d] + (a + 1) * 0.5 * (hi[:, :d] - lo[:, :d])
        return data


class AbsoluteAction:
    """delta -> absolute using current state; periodic dims wrapped."""

    def __init__(self, enable: bool = True):
        self.enable = enable

    def __call__(self, data: dict, **kw):
        if not self.enable:
            return data
        meta = data.get("meta_data", {})
        non_delta = meta.get("non_delta_mask")
        periodic = meta.get("periodic_mask")
        prange = meta.get("periodic_range")
        state = np.asarray(data["state"]).reshape(1, -1)
        action = np.asarray(data["action"])
        d = action.shape[-1]
        absolute = action + state[:, :d]
        if periodic is not None and prange is not None:
            for dim in periodic:
                a = absolute[..., dim]
                a = np.where(a > prange / 2, a - prange, a)
                a = np.where(a < -prange / 2, a + prange, a)
                absolute[..., dim] = a
        if non_delta is not None:
            absolute[..., non_delta] = action[..., non_delta]
        data["action"] = absolute
        return data


class Relative2Delta:
    """chunk of relative-to-frame actions -> per-step deltas."""

    def __init__(self, enable: bool = True):
        self.enable = enable

    def __call__(self, data: dict, **kw):
        if not self.enable:
            return data
        meta = data.get("meta_data", {})
        non_delta = meta.get("non_delta_mask")
        action = np.asarray(data["action"])
        delta = np.diff(action, axis=0, prepend=np.zeros((1, action.shape[-1])))
        if non_delta is not None:
            delta[..., non_delta] = action[..., non_delta]
        data["action"] = delta
        return data
