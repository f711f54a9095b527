"""Batched serving engine: continuous-batching prefill + decode loop.

Requests are left-padded (with token 0, which is attended, as in the
reference) into waves of at most ``batch_size``; a wave runs prefill, then
greedy decode steps until every request has its tokens or hit ``eos_id``,
and the next wave takes the freed slots. The semantics are those of
``repro.serving.engine.ServeEngine``, for every family (the audio and vlm
ones take their frame or patch embeddings as ``frontend``); the default
run config routes the model through the kernel-backed ops
(``attention_impl="flash"``). A wave on a CUDA device whose model step
takes its position on the device (``transformer.position_on_device``: a
dense or moe model, not on a mesh) decodes by replays of one CUDA graph of
the model's step (``DecodeGraph``); every other wave decodes eagerly.
Either way each step goes through this module's ``decode_step``, once,
which a caller may wrap to see every step's logits. Beside decoding, the
engine serves kernel-analysis requests through a co-resident ``AnalysisService``
on its own device (``analysis``, ``analyze_asm``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.transformer import Cache, Transformer, prefill
from repro_torch.tracing import span


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: List[int]
    tokens: List[int]


class DecodeGraph:
    """One CUDA graph of ``transformer.decode_step``, replayed for every
    decode step of a wave.

    The captured step reads its tokens from a static (B, 1) buffer and its
    position from the cache's ``pos``, a 0-d int64 tensor on the device
    (``start``), which the graph advances; so one capture serves every step
    of a wave, and every later wave whose cache tensors come back at the
    same addresses, shapes, strides and dtypes, at the same batch. Anything
    else is captured anew. The holder keeps the cache's addresses and
    layouts, never its tensors, so a wave's cache is freed with the wave.

    Captures run on a side stream into one memory pool
    (``torch.cuda.graph_pool_handle``), which every capture reuses. The old
    graph's outputs are dropped before a capture, so that it reuses their
    blocks, and the old graph itself once the capture has ended: a pool
    that no graph holds any more cannot be captured into again, and a graph
    cannot be destroyed while a capture is under way. Captures do not go
    through ``torch.cuda.graph``, which synchronizes and empties the
    allocator's cache on entry, so that the next prefill would allocate its
    blocks from the device again. A capture runs nothing, so the step that
    captured is replayed once, as every other. Replays add the captured
    step's kernel launches to ``ops.LAUNCHES``. A replay's logits live in a
    buffer that the next replay overwrites: a caller that keeps them copies
    them before the next step.
    """

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key: Optional[tuple] = None
        self.pool: Optional[tuple] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.tokens: Optional[torch.Tensor] = None
        self.logits: Optional[torch.Tensor] = None
        self.pos: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.captured = False  # whether the last step captured its graph

    def start(self, cache: Cache) -> Cache:
        """``cache`` with its int position moved into the holder's device
        position."""
        if self.pos is None:
            self.pos = torch.zeros((), dtype=torch.int64, device=cache["k"].device)
        self.pos.fill_(cache["pos"])
        return dict(cache, pos=self.pos)

    def step(self, params: Transformer, cfg: ModelConfig, run: RunConfig, cache: Cache,
             tokens: torch.Tensor):
        """``transformer.decode_step(params, cfg, run, cache, tokens)`` as a
        replay, captured first where ``cache`` or the batch differ from the
        captured ones; the cache is updated in place, ``pos`` included."""
        key = (tokens.shape, *((name, t.data_ptr(), t.shape, t.stride(), t.dtype)
                               for name, t in sorted(cache.items()) if torch.is_tensor(t)))
        self.captured = key != self.key
        if self.captured:
            self._capture(params, cfg, run, cache, tokens, key)
        self.tokens.copy_(tokens)
        self.graph.replay()
        for name, n in self.launches.items():
            ops.LAUNCHES[name] += n
        return self.logits, cache

    def _capture(self, params, cfg, run, cache, tokens, key) -> None:
        self.key = self.logits = None  # the old outputs' blocks free for the new graph
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(tokens.device)
        self.tokens = torch.empty_like(tokens)
        before = dict(ops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                logits, after = transformer.decode_step(params, cfg, run, cache, self.tokens)
                cache["pos"].copy_(after["pos"])
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(self.stream)
        self.launches = {name: ops.LAUNCHES[name] - n for name, n in before.items()}
        ops.LAUNCHES.update(before)  # the capture launched nothing
        self.graph, self.key, self.logits = graph, key, logits


def decode_step(params: Transformer, cfg: ModelConfig, run: RunConfig, cache: Cache,
                tokens: torch.Tensor, graph: Optional[DecodeGraph] = None):
    """The engine's decode step: ``transformer.decode_step``, or a replay of
    ``graph`` where one is given (then ``cache`` is one ``graph.start``
    gave). Returns (logits (B,1,V), cache)."""
    if graph is not None:
        return graph.step(params, cfg, run, cache, tokens)
    return transformer.decode_step(params, cfg, run, cache, tokens)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Transformer, *,
                 run: Optional[RunConfig] = None, batch_size: int = 4,
                 max_len: int = 512, device: Device = None):
        self.device = resolve_device(device)
        param_device = next(params.parameters()).device
        if param_device.type != self.device.type:
            raise ValueError(f"model weights are on {param_device}, engine "
                             f"device is {self.device}")
        self.cfg = cfg
        self.run = run or RunConfig(attention_impl="flash", attention_chunk=64,
                                    remat="none", zero=False)
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self._analysis = None
        self._graph = DecodeGraph()

    @property
    def analysis(self):
        """Co-resident kernel-analysis service (lazily constructed) on the
        engine's device, sharing this process's analysis LRU — see
        ``repro_torch.serving.analysis``."""
        if self._analysis is None:
            from repro_torch.serving.analysis import AnalysisService
            self._analysis = AnalysisService(device=self.device)
        return self._analysis

    def analyze_asm(self, requests):
        """Serve a batch of assembly-analysis requests alongside decoding."""
        return self.analysis.analyze_batch(list(requests))

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 frontend: Optional[torch.Tensor] = None) -> List[GenerationResult]:
        """Generate for a list of prompts with continuous batching.

        ``frontend`` (B, F, d) is an audio model's frame or a vlm's patch
        embeddings, moved to the engine's device; every wave takes it as it
        is, as the reference's engine does, so B is a wave's batch."""
        if frontend is not None:
            frontend = frontend.to(self.device)
        results = []
        queue = list(enumerate(prompts))
        with torch.inference_mode():
            while queue:
                wave = queue[:self.batch_size]
                queue = queue[self.batch_size:]
                results.extend(self._run_wave(wave, max_new_tokens, eos_id, frontend))
        return sorted(results, key=lambda r: r.request_id)

    def _run_wave(self, wave, max_new_tokens, eos_id, frontend):
        """One wave: prefill, then greedy decode. Under the profiler it
        records a ``serve.wave`` span around ``serve.prefill``, each step's
        ``serve.tokens`` (the argmax and the host's read of it) and each
        ``serve.decode`` (step s gives token s + 1). Decode's spans take no
        timing events (``repro_torch.tracing``): a captured step must not
        record any, and an eager one is host-paced. Each ``serve.decode``
        span's ``graph`` field reads ``"replay"`` or ``"eager"``, and
        ``captured`` whether that step captured the graph it replays."""
        b = len(wave)
        plen = max(len(p) for _, p in wave)
        graph = (self._graph if self.device.type == "cuda"
                 and transformer.position_on_device(self.cfg, self.params.embed) else None)
        with span("serve.wave", requests=[rid for rid, _ in wave], batch=b, padded=plen,
                  prompt_tokens=sum(len(p) for _, p in wave)):
            with span("serve.prefill", batch=b, padded=plen):
                tokens = np.zeros((b, plen), np.int64)
                for i, (_, p) in enumerate(wave):
                    tokens[i, plen - len(p):] = p  # left-pad

                # Prefill sizes the cache for the whole generation budget
                # (a vlm's frontend positions left out of it, as in the
                # reference), and decode steps in it as it is.
                logits, cache = prefill(self.params, self.cfg, self.run,
                                        torch.from_numpy(tokens).to(self.device),
                                        max_len=plen + max_new_tokens, frontend=frontend)
            if graph is not None:
                cache = graph.start(cache)

            out_tokens = [[] for _ in range(b)]
            done = [False] * b
            for step in range(max_new_tokens):
                with span("serve.tokens", timed=False, step=step):
                    cur = logits[:, -1].argmax(dim=-1)
                    new = cur.tolist()
                for i, tok in enumerate(new):
                    if not done[i]:
                        out_tokens[i].append(tok)
                        if eos_id is not None and tok == eos_id:
                            done[i] = True
                # The reference also decodes after the last token and drops
                # the result; skipping that step changes no token.
                if all(done) or step == max_new_tokens - 1:
                    break
                with span("serve.decode", timed=False, step=step) as decode:
                    logits, cache = decode_step(self.params, self.cfg, self.run, cache,
                                                cur[:, None], graph=graph)
                if decode is not None:
                    decode.fields.update(graph="eager" if graph is None else "replay",
                                         captured=graph is not None and graph.captured)

        return [GenerationResult(request_id=rid, prompt=list(p),
                                 tokens=out_tokens[i])
                for i, (rid, p) in enumerate(wave)]
