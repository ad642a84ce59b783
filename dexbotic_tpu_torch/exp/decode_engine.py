"""Continuous batching for autoregressive policies (Discrete VLA, MUVLA,
NaVILA fleets): slot-based decode-step coalescing (port of
dexbotic_tpu/exp/decode_engine.py).

Requests join and leave a fixed set of decode SLOTS at token-step
granularity, so one batched decode step serves every in-flight request:

  * one engine KV cache of shape [slots, max_prompt + max_new, ...], bf16;
    each slot owns its row.  Buffer columns are storage, not logical
    positions: RoPE positions and the group/valid masks are explicit, so
    rows at different depths share one attention call (kernel K1 on a CUDA
    device: one query row a slot, empty and finished slots seeing no key).
  * ADMIT: a prefill of the admitted prompts (padded to 64-token buckets)
    into a fresh bucket-wide bf16 cache, whose rows, with a zero tail, and
    last hidden states are written into the engine's at the free slots.
  * STEP: ``steps_per_tick`` decode steps a tick: sample -> embed -> one
    single-token forward with per-row ``write_cols`` (nn/transformer.py
    mot_forward) into the engine cache, in place -> the new hidden state.
    The hidden state between steps is bf16 (``last_hidden``), as the JAX
    engine keeps it.  Finished and empty slots ride along masked
    (valid=0); their writes land past the prompt or, for a slot whose decode
    filled its row, past the cache's end and are dropped.
  * RETIRE: on the host, slots whose row drew EOS or reached its max_new
    free up and the next queued request is admitted.

Optional ``prefill_chunk``: admission feeds the prompt ``chunk`` tokens at a
time straight into the engine cache (the tower and splice run once up
front; each LLM chunk runs at B=slots, the other rows parked on the column
past the cache's end so that their writes drop; groups and positions
continue per row from the cache's valid count), with one decode tick for
the live slots between chunks: a long prefill no longer stalls in-flight
generations for its whole duration, and admission allocates no second KV
cache.

Where the JAX engine donates its cache to the step program, this one writes
into its own cache in place; a step that fails midway leaves it in an
unknown state, so the in-flight requests fail and the state is rebuilt, as
there.  Temperature > 0 draws from the engine's ``torch.Generator``.

Threads and streams: a request's prompt, images and embeds are uploaded on
the SUBMITTING thread (so that the host-to-device copies overlap the loop's
ticks), on that thread's current stream, and a CUDA event is recorded
behind them; the loop thread makes its own current stream wait on that
event before it reads them (and records its stream on the tensors for the
caching allocator), so the order holds whatever streams the two threads use.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from dexbotic_tpu_torch.models.vlm import VLM, VLMConfig, encode_images, splice_image_embeds, vlm_forward
from dexbotic_tpu_torch.nn.transformer import embed_tokens, init_kv_cache, lm_logits


def _bucket(n: int, mult: int = 64) -> int:
    return -(-n // mult) * mult


@dataclass
class _Request:
    ids: np.ndarray  # int[S] prompt (unpadded)
    max_new: int
    event: threading.Event = field(default_factory=threading.Event)
    tokens: list = field(default_factory=list)
    error: Optional[Exception] = None
    slot: int = -1
    # device-staged inputs, uploaded on the submitting thread (see the module docstring)
    bucket: int = 0
    ids_dev: Optional[torch.Tensor] = None  # int32 [bucket] padded prompt
    valid_dev: Optional[torch.Tensor] = None  # int32 [bucket]
    images_dev: Optional[torch.Tensor] = None
    embeds_dev: Optional[torch.Tensor] = None  # [bucket, H], the caller's dtype
    ready: Optional[torch.cuda.Event] = None  # recorded behind the uploads (CUDA)


class ContinuousBatchingEngine:
    """Token-level request coalescing over a fixed slot set.

    Args:
        vlm/cfg: a VLM-like module (``llm``, ``vit``, ``projector``) and its
            config, as ``models/vlm.vlm_forward`` takes them.
        slots: max concurrent decodes (the decode batch size).
        max_prompt: prompt capacity per slot (a prompt's bucket is capped at it).
        max_new: decode capacity per slot.
        eos_token_id / pad_token_id / temperature: sampling config.
        steps_per_tick: decode steps a tick (finished slots emit pads that
            are dropped on the host).
        prefill_chunk: chunked admission (see the module docstring); None or
            0 for the one-shot prefill.
        generator: the draws of temperature > 0 (seeded 0 on the device
            when None).
    """

    def __init__(self, vlm: VLM, cfg: VLMConfig, *, slots: int = 8, max_prompt: int = 512,
                 max_new: int = 64, eos_token_id: int = 2, pad_token_id: int = 0,
                 temperature: float = 0.0, steps_per_tick: int = 4,
                 prefill_chunk: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        self.vlm, self.cfg = vlm, cfg
        self.device = next(vlm.parameters()).device
        self.S, self.P, self.N = slots, max_prompt, max_new
        self.eos, self.pad = eos_token_id, pad_token_id
        self.temperature = temperature
        self.k = steps_per_tick
        self.chunk = None if not prefill_chunk else int(prefill_chunk)
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(0))

        self._epoch = -1  # bumped by _reset_state; detects mid-admission resets
        self._reset_state()
        # host mirrors of per-slot state
        self.prompt_len = np.zeros(slots, np.int32)
        self.n_dec = np.zeros(slots, np.int32)
        self.live = np.zeros(slots, bool)
        self.reqs: list[Optional[_Request]] = [None] * slots
        self.batched_steps = 0  # ticks that served more than one slot
        # the wall clock of each decode tick (bounded): the largest gap
        # between ticks while slots are live is the stall an in-flight
        # generation sees during admissions
        self.tick_times: list[float] = []
        # (t_start, t_end, n_reqs, bucket, chunked) per admission batch (bounded)
        self.admit_log: list[tuple] = []

        self._queue: queue.Queue = queue.Queue()
        self._wake = threading.Event()
        self._stop = False
        self._dead: Optional[Exception] = None  # a fatal engine failure
        self._step_fn = self._step
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- device programs --------------------------------------------------

    def _prefill(self, ids, valid, images, embeds):
        """One padded prefill of B admitted prompts into a fresh bucket-wide
        bf16 cache: (cache, last valid hidden state [B, H])."""
        B, bucket = ids.shape
        cache = init_kv_cache(self.cfg.llm, B, bucket, dtype=torch.bfloat16, device=self.device)
        hidden, cache = vlm_forward(self.vlm, self.cfg, ids, valid, images=images,
                                    inputs_embeds=embeds, cache=cache, update_cache=True)
        last = hidden[torch.arange(B, device=self.device), valid.sum(1).long() - 1]
        return cache, last

    def _embed(self, ids, images):
        """ids (+images) -> the spliced prompt embeds [B, bucket, H]: the
        tower runs once whatever the chunking; only the LLM prefill is chunked."""
        if images is None:
            return embed_tokens(self.vlm.llm, self.cfg.llm, ids)
        feats = encode_images(self.vlm, self.cfg, images)
        return splice_image_embeds(self.vlm, self.cfg, ids, feats)

    def _chunk(self, emb, valid, off: int, lens, slots, clear: bool) -> None:
        """One in-cache prefill chunk: the admitted rows' slice of the
        prompt at B=slots straight into the engine cache, the other rows
        parked at column C (their writes drop), and the running last valid
        hidden state of each admitted row."""
        S, C, dev = self.S, self.P + self.N, self.device
        if clear:  # an admission's first chunk: the rows' stale occupancy goes
            for f in ("grp", "valid", "seg"):
                self.cache[f][slots] = 0
        c, H = emb.shape[1], emb.shape[2]
        emb_s = torch.zeros((S, c, H), dtype=emb.dtype, device=dev)
        emb_s[slots] = emb
        valid_s = torch.zeros((S, c), dtype=torch.int32, device=dev)
        valid_s[slots] = valid.to(torch.int32)
        offs = torch.full((S,), C, dtype=torch.int32, device=dev)
        offs[slots] = off
        hidden, self.cache = vlm_forward(
            self.vlm, self.cfg, torch.zeros((S, c), dtype=torch.int32, device=dev), valid_s,
            inputs_embeds=emb_s, cache=self.cache, update_cache=True, write_cols=offs)
        lens_s = torch.zeros((S,), dtype=torch.long, device=dev)
        lens_s[slots] = lens
        rel = (lens_s - 1 - off).clamp(0, c - 1)
        cand = hidden[torch.arange(S, device=dev), rel]
        in_chunk = (lens_s - 1 >= off) & (lens_s - 1 < off + c)
        self.last_hidden = torch.where(in_chunk[:, None], cand.to(self.last_hidden.dtype),
                                       self.last_hidden)

    def _install(self, pcache, plast, slots) -> None:
        """Write B prefilled rows (bucket columns) into the engine cache at
        rows ``slots``, zeroing the rest of each row."""
        bucket = pcache["grp"].shape[1]
        for f in ("k", "v"):
            buf = self.cache[f]
            buf[:, slots, :bucket] = pcache[f].to(buf.dtype)
            buf[:, slots, bucket:] = 0
        for f in ("grp", "valid", "seg"):
            buf = self.cache[f]
            src = pcache.get(f)
            buf[slots, :bucket] = 0 if src is None else src
            buf[slots, bucket:] = 0
        self.last_hidden[slots] = plast.to(self.last_hidden.dtype)

    @torch.no_grad()
    def _step(self, prompt_len, n_dec, done, cap, k: int):
        """``k`` decode steps of every slot: (tokens [k, S], n_dec, done),
        device tensors; the engine cache and ``last_hidden`` advance in place."""
        vlm, cfg = self.vlm, self.cfg
        hid, toks = self.last_hidden, []
        for _ in range(k):
            logits = lm_logits(vlm.llm, cfg.llm, hid).float()
            if self.temperature and self.temperature > 0:
                probs = torch.softmax(logits / self.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
            else:
                tok = logits.argmax(-1)
            tok = torch.where(done, self.pad, tok).to(torch.int32)
            emb = embed_tokens(vlm.llm, cfg.llm, tok[:, None], dtype=hid.dtype)
            pos = (prompt_len + n_dec)[:, None]
            # a done row still writes: past its tokens, or at column C (dropped)
            hidden, self.cache = vlm_forward(
                vlm, cfg, tok[:, None], (~done).to(torch.int32)[:, None], inputs_embeds=emb,
                positions=pos, grp=pos + 1, cache=self.cache, update_cache=True,
                write_cols=self.P + n_dec)
            n_dec = n_dec + (~done).to(torch.int32)
            done = done | (tok == self.eos) | (n_dec >= cap)
            hid = hidden[:, 0]
            toks.append(tok)
        self.last_hidden = hid
        return torch.stack(toks), n_dec, done

    # ---- host loop --------------------------------------------------------

    def submit(self, ids, images=None, embeds=None, max_new: Optional[int] = None,
               timeout: float = 900.0) -> list:
        """Blocking: the generated token list (pads and tokens after EOS trimmed).

        ``images`` [n, H, W, 3] (or [H, W, 3]) for the tower, or ``embeds``
        [L, H] (numpy or a tensor on any device): the pre-spliced prompt."""
        ids = np.asarray(ids).reshape(-1)
        if self._dead is not None:
            raise RuntimeError("decode engine is dead") from self._dead
        if ids.shape[0] > self.P:
            raise ValueError(f"prompt {ids.shape[0]} > max_prompt {self.P}")
        r = _Request(ids=ids, max_new=min(max_new or self.N, self.N))
        L = ids.shape[0]
        r.bucket = min(_bucket(max(L, 1)), self.P)
        pad_ids = np.zeros(r.bucket, np.int32)
        pad_ids[:L] = ids
        dev = self.device
        with torch.no_grad():
            r.ids_dev = torch.from_numpy(pad_ids).to(dev)
            r.valid_dev = (torch.arange(r.bucket, device=dev) < L).to(torch.int32)
            if images is not None:
                r.images_dev = torch.as_tensor(images, dtype=torch.float32).to(dev)
            if embeds is not None:
                e = torch.as_tensor(embeds).to(dev)
                r.embeds_dev = torch.nn.functional.pad(e, (0, 0, 0, r.bucket - L))
        if dev.type == "cuda":
            r.ready = torch.cuda.Event()
            r.ready.record(torch.cuda.current_stream(dev))
        self._queue.put(r)
        self._wake.set()
        if not r.event.wait(timeout=timeout):
            raise TimeoutError("decode engine timed out")
        if r.error is not None:
            raise r.error
        return r.tokens

    def close(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)

    def _staged(self, reqs: list):
        """The requests' staged tensors, stacked, ordered after their uploads."""
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for r in reqs:
                stream.wait_event(r.ready)
                for t in (r.ids_dev, r.valid_dev, r.images_dev, r.embeds_dev):
                    if t is not None:
                        t.record_stream(stream)
        ids = torch.stack([r.ids_dev for r in reqs])
        valid = torch.stack([r.valid_dev for r in reqs])
        images = None if reqs[0].images_dev is None else torch.stack([r.images_dev for r in reqs])
        embeds = None if reqs[0].embeds_dev is None else torch.stack([r.embeds_dev for r in reqs])
        return ids, valid, images, embeds

    @torch.no_grad()
    def _admit_batch(self, reqs: list, slots: list, bucket: int):
        """One padded prefill and one install for a group of requests of one
        bucket and input kind (or one chunked admission of them)."""
        t0 = time.perf_counter()
        B = len(reqs)
        ids_d, valid_d, images, embeds = self._staged(reqs)
        slots_t = torch.tensor(slots, dtype=torch.long, device=self.device)
        chunked = bool(self.chunk and self.chunk < bucket)
        if chunked:
            if embeds is None:
                embeds = self._embed(ids_d, images)
            lens = torch.tensor([r.ids.shape[0] for r in reqs], device=self.device)
            needed = int(max(r.ids.shape[0] for r in reqs))
            try:
                for s in slots:
                    self.n_dec[s] = 0  # the ticks' writes of this not-yet-live row land at P
                epoch = self._epoch
                for off in range(0, needed, self.chunk):
                    c = min(self.chunk, bucket - off)
                    self._chunk(embeds[:, off:off + c], valid_d[:, off:off + c], off, lens,
                                slots_t, off == 0)
                    if off + c < needed:
                        self._decode_tick()
                        if self._epoch != epoch:
                            # a failed tick reset the engine: the partial prompt is gone
                            raise RuntimeError("engine state reset during chunked admission")
            except Exception as e:  # noqa: BLE001
                # the chunks write the engine cache in place: in-flight slots are lost too
                self._fail_live(e)
                self._reset_state()
                raise
        else:
            pcache, plast = self._prefill(ids_d, valid_d, images, embeds)
            try:
                self._install(pcache, plast, slots_t)
            except Exception as e:  # noqa: BLE001
                self._fail_live(e)
                self._reset_state()
                raise
        for r, slot in zip(reqs, slots):
            self.prompt_len[slot] = r.ids.shape[0]
            self.n_dec[slot] = 0
            self.live[slot] = True
            self.reqs[slot] = r
            r.slot = slot
        if len(self.admit_log) < 65536:
            self.admit_log.append((t0, time.perf_counter(), B, bucket, chunked))

    def _loop(self):
        try:
            self._loop_inner()
        except Exception as e:  # noqa: BLE001
            # the loop thread never dies silently: the engine is marked dead,
            # and queued and later submits fail at once
            self._dead = e
            self._fail_live(e)
            while True:
                try:
                    r = self._queue.get_nowait()
                except queue.Empty:
                    break
                r.error = e
                r.event.set()

    def _loop_inner(self):
        while not self._stop:
            # admit queued requests into free slots, grouped by prefill
            # signature so that each group is one batched prefill
            free = [s for s in range(self.S) if not self.live[s]]
            pending = []
            while len(pending) < len(free):
                try:
                    pending.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            if pending:
                groups: dict = {}
                for r in pending:
                    sig = (r.bucket,
                           None if r.images_dev is None else tuple(r.images_dev.shape),
                           None if r.embeds_dev is None
                           else (r.embeds_dev.shape[-1], str(r.embeds_dev.dtype)))
                    groups.setdefault(sig, []).append(r)
                it = iter(free)
                for (bucket, _, _), reqs in groups.items():
                    slots = [next(it) for _ in reqs]
                    try:
                        self._admit_batch(reqs, slots, bucket)
                    except Exception as e:  # noqa: BLE001
                        for r in reqs:
                            r.error = e
                            r.event.set()
            if not self.live.any():
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            self._decode_tick()

    def _decode_tick(self):
        """One tick (``steps_per_tick`` tokens) for every live slot, then
        the host-side retire.  Called from the loop and from inside chunked
        admissions (between prefill chunks)."""
        if not self.live.any():
            return
        if len(self.tick_times) < 65536:
            self.tick_times.append(time.perf_counter())
        if int(self.live.sum()) > 1:
            self.batched_steps += 1
        cap = self._max_new_arr()
        dev = self.device
        try:
            toks, n_dec, done = self._step_fn(
                torch.from_numpy(self.prompt_len).to(dev), torch.from_numpy(self.n_dec).to(dev),
                torch.from_numpy(~self.live | (self.n_dec >= cap)).to(dev),
                torch.from_numpy(cap).to(dev), self.k)
            toks = toks.cpu().numpy()  # [k, S]
            self.n_dec = n_dec.cpu().numpy().astype(np.int32)
            done_np = done.cpu().numpy()
        except Exception as e:  # noqa: BLE001
            # fail every in-flight request rather than hang its client; the
            # step wrote the cache in place, so a fresh empty state is built
            # before anything else is served
            self._fail_live(e)
            self._reset_state()  # raising here marks the engine dead (_loop)
            return
        for slot in range(self.S):
            req = self.reqs[slot]
            if req is None or not self.live[slot]:
                continue
            for t in toks[:, slot]:
                if len(req.tokens) >= req.max_new or (req.tokens and req.tokens[-1] == self.eos):
                    break
                req.tokens.append(int(t))
            finished = (done_np[slot] or len(req.tokens) >= req.max_new
                        or (req.tokens and req.tokens[-1] == self.eos))
            if finished:
                self.live[slot] = False
                self.reqs[slot] = None
                req.event.set()

    def _fail_live(self, e: Exception):
        for slot in range(self.S):
            req = self.reqs[slot]
            if req is not None:
                req.error = e
                self.live[slot] = False
                self.reqs[slot] = None
                req.event.set()

    def _reset_state(self):
        self._epoch += 1
        self.cache = init_kv_cache(self.cfg.llm, self.S, self.P + self.N, dtype=torch.bfloat16,
                                   device=self.device)
        self.last_hidden = torch.zeros((self.S, self.cfg.llm.hidden_size), dtype=torch.bfloat16,
                                       device=self.device)

    def _max_new_arr(self) -> np.ndarray:
        out = np.full(self.S, self.N, np.int32)
        for slot, req in enumerate(self.reqs):
            if req is not None:
                out[slot] = req.max_new
        return out
