"""Wave-based continuous batching for the LM prefill/decode path, the port
of ``_Wave`` and ``LMEngine`` from ``repro/serve/engine.py``.

The decode step takes one position for the whole batch, so lanes cannot
be at different sequence offsets inside one batch: requests are grouped
into *waves* that prefill together and decode in lockstep.  Between decode
slices of the active wave the engine prefills the next wave, so when the
active wave retires the next one starts decoding at once.

Not ported yet: ``ODEEngine`` (ROADMAP Queue 1 item 12), the mesh and
sharded replicas (item 14), and the fault sites / metrics hooks (item 11).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import lm as lm_mod
from repro_torch.models.ode_nets import resolve_device
from repro_torch.serve.queue import RequestQueue, Ticket

__all__ = ["LMEngine"]


class _Wave:
    """One cohort of lanes decoding in lockstep (one shared position)."""

    def __init__(self, batch, state, tok, pos0: int, max_gen: int):
        self.batch = batch              # [(Request, Ticket)] real lanes
        self.state = state
        self.tok = tok                  # (lanes, 1) int64, last sampled
        self.pos0 = int(pos0)
        self.max_gen = int(max_gen)
        self.emitted: List[torch.Tensor] = []   # per-step (lanes,) tokens

    @property
    def done(self) -> bool:
        return len(self.emitted) >= self.max_gen


class LMEngine:
    """Wave-based continuous batching for the LM prefill/decode path.

    ``params`` is a tree on ``device`` (e.g. from ``convert.params_from_jax``)
    or None for random weights drawn from ``seed`` on a generator on that
    device.  Sampling is greedy at ``temperature <= 0``: ``argmax``, which
    returns the first maximal index, as ``jnp.argmax`` does.  Above 0 it
    draws with the Gumbel-max rule from a ``torch.Generator`` on the device
    seeded from ``seed + 1``; those draws cannot match ``jax.random``'s.

    ``call_log`` records every device call (op, wall seconds, tokens
    emitted, lanes, and ``compile``, which here marks the first call of
    each op, the one that pays the kernel build and CUDA/cuBLAS set-up).
    ``launch/serve.py`` splits warm-up from steady state with it.
    """

    def __init__(self, cfg, *, lanes: int, prompt_len: int, max_gen: int,
                 decode_slice: int = 4, temperature: float = 0.0,
                 seed: int = 0, params=None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lanes = int(lanes)
        self.prompt_len = int(prompt_len)
        self.max_gen = int(max_gen)
        self.decode_slice = max(1, int(decode_slice))
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.max_seq = self.prompt_len + self.max_gen
        self.queue = RequestQueue(
            kinds=("lm",), dim=self.prompt_len,
            max_payload_bytes=max(1 << 20, 8 * self.prompt_len))
        self.call_log: List[Dict[str, Any]] = []
        self._active: Optional[_Wave] = None
        self._staged: Optional[_Wave] = None
        self._decode_calls = 0
        self.pos0 = self.prompt_len
        if params is None:
            gen = torch.Generator(self.device).manual_seed(self.seed)
            params = lm_mod.init_params(cfg, gen, device=self.device)
        self.params = params
        self._prefill_fn = make_prefill_step(cfg, max_seq=self.max_seq)
        self._decode_fn = make_decode_step(cfg)
        self._gen = torch.Generator(self.device).manual_seed(self.seed + 1)

    # -- client API ----------------------------------------------------------
    def submit(self, prompt, *, gen: Optional[int] = None,
               priority: float = 0.0, rid: Optional[str] = None) -> Ticket:
        """Admit one prompt (``(prompt_len,)`` int tokens).  ``gen`` caps
        this request's emitted tokens (<= engine ``max_gen``)."""
        gen = self.max_gen if gen is None else min(int(gen), self.max_gen)
        return self.queue.submit("lm", np.asarray(prompt, np.int32),
                                 priority=priority, rid=rid,
                                 meta={"gen": gen})

    # -- internals -----------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device).clamp_(min=1e-20)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() / self.temperature + gumbel,
                            dim=-1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill_next(self) -> Optional[_Wave]:
        batch = self.queue.next_batch(self.lanes, kind="lm")
        if not batch:
            return None
        toks = np.zeros((self.lanes, self.prompt_len), np.int32)
        for i, (req, _) in enumerate(batch):
            toks[i] = req.payload
        prompt = {"tokens": torch.from_numpy(toks).to(self.device)}
        compile_ = not self.call_log  # the first call of the engine
        t_start = time.time()
        with torch.no_grad():
            state, logits = self._prefill_fn(self.params, prompt)
            tok = self._sample(logits)[:, None]
        self._sync()
        wall = time.time() - t_start
        max_gen = max(r.meta["gen"] for r, _ in batch)
        wave = _Wave(batch, state, tok, self.pos0, max_gen)
        # the prefill's sampled token is token #1 of every lane and counts
        # toward throughput
        wave.emitted.append(tok[:, 0])
        self.call_log.append({"op": "prefill", "wall_s": wall,
                              "tokens": len(batch), "compile": compile_,
                              "lanes": len(batch)})
        return wave

    def _decode_slice(self, wave: _Wave) -> None:
        k = min(self.decode_slice, wave.max_gen - len(wave.emitted))
        if k <= 0:
            return
        compile_ = self._decode_calls == 0
        t_start = time.time()
        with torch.no_grad():
            for _ in range(k):
                i = len(wave.emitted) - 1  # decode steps taken so far
                logits, wave.state = self._decode_fn(
                    self.params, wave.state, wave.tok, wave.pos0 + i)
                wave.tok = self._sample(torch.nan_to_num(logits))[:, None]
                wave.emitted.append(wave.tok[:, 0])
        self._sync()
        wall = time.time() - t_start
        self._decode_calls += 1
        self.call_log.append({"op": "decode", "wall_s": wall,
                              "tokens": k * len(wave.batch), "steps": k,
                              "compile": compile_, "lanes": len(wave.batch)})

    def _retire(self, wave: _Wave) -> None:
        tick = self.queue.tick
        grid = torch.stack(wave.emitted, dim=1).cpu().numpy().astype(np.int32)
        for i, (req, ticket) in enumerate(wave.batch):
            ticket.set_result(grid[i, :req.meta["gen"]].copy(), tick)

    def step(self) -> bool:
        """One scheduling quantum.  Activates a staged/new wave, decodes
        one slice, and interleaves the NEXT wave's prefill between slices
        of the active one.  Returns False when fully idle."""
        if self._active is None:
            self._active = self._staged or self._prefill_next()
            self._staged = None
            return self._active is not None
        self._decode_slice(self._active)
        if self._active.done:
            self._retire(self._active)
            self._active = None
            return True
        if self._staged is None and self.queue.depth() > 0:
            self._staged = self._prefill_next()
        return True

    def run(self, max_quanta: int = 100_000) -> None:
        """Drive until queue + waves drain."""
        for _ in range(max_quanta):
            busy = self.step()
            if not busy and self.queue.depth() == 0 \
                    and self._active is None and self._staged is None:
                return
        raise RuntimeError("LMEngine.run did not drain "
                           f"within {max_quanta} quanta")
