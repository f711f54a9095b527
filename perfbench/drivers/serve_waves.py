"""Waves of serving requests, and the driver of every mix whose ``driver``
is ``serve_waves``: a closed loop of ``ServeEngine.generate`` calls, one
wave of ``batch_size`` requests each.

Every wave holds the same ``batch_size`` prompt lengths: the quantiles
(i + 0.5) / batch_size of a lognormal of median ``prompt_median`` and shape
``prompt_sigma``, rounded and clipped to [``prompt_min``, ``prompt_max``].
The seed and the wave's index place the lengths in the wave and draw every
token (uniform over 1 .. vocab - 1), so each call is new and every seed does
the same work.

A request is submitted when its call starts and done when the call returns,
so its latency is its call's. The output check runs after the window, with
the program's state freed: the sampled waves (``sample_waves`` of the
window's first ``sample_from`` calls, drawn from the seed before the
window) go through the family's float32 reference, over the left-padded
prompts and the served tokens. On the sampled calls the harness keeps the
logits the engine chose each token from. ``own_gap`` is the widest gap by
which a served token's logit lies below the best of those logits: the
engine serves its own greedy choice, so it is 0 exactly. ``logit_error`` is,
for the worst sampled request, the median over its served positions of the
relative error of those logits against the reference's. ``served_gap`` is
the widest gap by which a served token's logit lies below the reference's
best at its position. The cell's limits file names which are compared.
"""

from __future__ import annotations

import math
import statistics
import time
from statistics import NormalDist
from typing import List

import numpy as np
import torch

from perfbench.drivers import common
from perfbench.reference import ops as ref_ops
from perfbench.reference.weights import Weights


def lengths(mix: dict) -> List[int]:
    n = mix["batch_size"]
    out = []
    for i in range(n):
        z = NormalDist().inv_cdf((i + 0.5) / n)
        length = round(math.exp(math.log(mix["prompt_median"]) + mix["prompt_sigma"] * z))
        out.append(min(max(length, mix["prompt_min"]), mix["prompt_max"]))
    return out


def rng(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *index])


def wave(mix: dict, seed: int, index: int, vocab: int) -> List[List[int]]:
    """The prompts of call ``index`` (index -1: the warm-up wave)."""
    r = rng(seed, index + 1)
    return [r.integers(1, vocab, size=n).tolist() for n in r.permutation(lengths(mix))]


class Cell:
    traced_calls = 1  # a call is a whole wave: prefill and every decode step

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.m, self.mix, self.seed, self.device = config["model"], mix, seed, device
        self.family = common.family(self.m)
        self.spec = self.family.param_spec(self.m)
        self.engine = None
        self.min_calls = mix["sample_from"]
        self.sampled = set(rng(seed, 1 << 32).choice(
            mix["sample_from"], size=mix["sample_waves"], replace=False).tolist())
        self._logits, self._restore = None, []

    # -- the program ---------------------------------------------------------

    def _keep_logits(self, engine_module) -> None:
        """Wrap the engine's prefill and decode step so that, on a sampled
        call, each last position's logits (what the engine chooses its token
        from) are copied to the host, where they take none of the card's
        memory; the calls are otherwise untouched (the engine reads each
        step's tokens on the host right after)."""
        for name in ("prefill", "decode_step"):
            real = getattr(engine_module, name)

            def kept(*args, _real=real, **kwargs):
                logits, cache = _real(*args, **kwargs)
                if self._logits is not None:
                    self._logits.append(logits[:, -1, :self.m["vocab"]].float().cpu())
                return logits, cache

            setattr(engine_module, name, kept)
            self._restore.append((engine_module, name, real))

    def setup(self) -> None:
        from repro_torch.serving import engine as engine_module

        model = common.build_model(self.m, self.spec, self.seed, self.device)
        self.engine = engine_module.ServeEngine(
            common.model_config(self.m), model, batch_size=self.mix["batch_size"],
            max_len=max(lengths(self.mix)) + self.mix["new_tokens"],
            device=self.device)
        self._keep_logits(engine_module)
        self._generate(wave(self.mix, self.seed, -1, self.m["vocab"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _generate(self, prompts):
        return self.engine.generate(prompts, max_new_tokens=self.mix["new_tokens"],
                                    eos_id=self.mix["eos_id"])

    def call(self, index: int) -> dict:
        prompts = wave(self.mix, self.seed, index, self.m["vocab"])
        self._logits = [] if index in self.sampled else None
        t0 = time.perf_counter()
        results = self._generate(prompts)
        t1 = time.perf_counter()
        record = {"index": index, "t0": t0, "t1": t1, "prompts": prompts,
                  "tokens": [r.tokens for r in sorted(results, key=lambda r: r.request_id)]}
        if self._logits is not None:
            record["logits"] = torch.stack(self._logits, dim=1)  # (B, new, vocab)
            self._logits = None
        return record

    def release(self) -> None:
        self.engine = None
        for module, name, real in self._restore:
            setattr(module, name, real)
        self._restore = []
        common.free_memory()

    # -- what the window gives --------------------------------------------------

    def counts(self, records: List[dict]):
        attempted = sum(len(r["prompts"]) for r in records)
        failed = sum(len(t) != self.mix["new_tokens"] for r in records for t in r["tokens"])
        return attempted, failed

    def end_to_end(self, records: List[dict], window_s: float) -> dict:
        tokens = sum(len(p) + len(t) for r in records for p, t in zip(r["prompts"], r["tokens"]))
        latency = [(r["t1"] - r["t0"]) * 1e3 for r in records for _ in r["prompts"]]
        p95 = (statistics.quantiles(latency, n=20, method="inclusive")[-1]
               if len(latency) > 1 else latency[0])
        return {"serve_tok_s": tokens / window_s, "latency_p95_ms": p95}

    # -- the output check -----------------------------------------------------------

    def sample(self, records: List[dict]) -> List[dict]:
        """The sampled calls; every wave holds the mix's longest prompt."""
        return [r for r in records if r["index"] in self.sampled]

    def reference_input(self, record: dict):
        """(tokens (B, P + new - 1), P, served (B, new)): the left-padded
        prompts (pad 0, as the engine pads) and every served token but the
        last, on the device."""
        new = self.mix["new_tokens"]
        plen = max(len(p) for p in record["prompts"])
        rows = np.zeros((len(record["prompts"]), plen + new - 1), np.int64)
        for i, (p, t) in enumerate(zip(record["prompts"], record["tokens"])):
            rows[i, plen - len(p):plen] = p
            rows[i, plen:] = t[:new - 1]
        served = torch.tensor(record["tokens"], dtype=torch.long, device=self.device)
        return torch.from_numpy(rows).to(self.device), plen, served

    def reference_logits(self, record: dict, matmul: str = "exact"):
        tokens, plen, served = self.reference_input(record)
        w = Weights(self.spec, self.seed, self.device, common.dtype(self.m))
        with torch.no_grad():
            logits = self.family.serve_logits(self.m, w.get, tokens, plen, ref_ops.MATMULS[matmul])
        return logits, served

    @staticmethod
    def gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
        """By how much each chosen token's logit lies below the best; a token
        outside the vocabulary lies infinitely far below."""
        best = logits.max(dim=-1).values
        inside = (chosen >= 0) & (chosen < logits.shape[-1])
        picked = logits.gather(-1, torch.where(inside, chosen, 0)[..., None])[..., 0]
        return torch.where(inside, best - picked, math.inf)

    @staticmethod
    def logit_error(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
        """At each position, the root mean square of got - want over the
        vocabulary, relative to that of want."""
        def rms(t):
            return t.square().mean(dim=-1).sqrt()

        return rms(got - want) / rms(want)

    @staticmethod
    def summary(gaps: List[torch.Tensor], own: List[torch.Tensor],
                errors: List[torch.Tensor]) -> dict:
        """``served_gap``, the widest gap of a served token below the
        reference's best; ``own_gap``, the widest below the best of the
        logits it was chosen from; ``logit_error``, the largest over the
        requests of the median over a request's positions of the relative
        logit error. A request that never came, or came short, and a NaN
        read inf."""
        def widest(parts):
            values = (float(g.max()) for g in parts)
            return max((math.inf if math.isnan(v) else v for v in values), default=math.inf)

        out = {"served_gap": widest(gaps), "own_gap": widest(own),
               "logit_error": widest([e.median(dim=-1).values for e in errors])}
        return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}

    def readings(self, records: List[dict], control: bool = False):
        """The readings of the program's sampled waves; with ``control``
        also those of the float8 reference in the program's place at the
        same positions (it serves the tokens it puts first), else None."""
        ref_ops.float32_strict()
        sample = self.sample(records)
        lost = [torch.tensor([math.inf])] * (len(sample) < len(self.sampled))  # one never came
        served, own, errors = list(lost), list(lost), []
        low_gaps, low_own, low_errors = [], [], []
        for record in sample:
            if any(len(t) != self.mix["new_tokens"] for t in record["tokens"]):
                served.append(torch.tensor([math.inf]))
                own.append(torch.tensor([math.inf]))
                errors.append(torch.full((1, 1), math.inf))
                continue
            logits, tokens = self.reference_logits(record)
            kept = record["logits"].to(logits.device)
            served.append(self.gaps(logits, tokens).cpu())
            own.append(self.gaps(kept, tokens).cpu())
            errors.append(self.logit_error(kept, logits).cpu())
            del kept
            if control:
                fp8, _ = self.reference_logits(record, "fp8")
                chosen = fp8.argmax(-1)
                low_gaps.append(self.gaps(logits, chosen).cpu())
                low_own.append(self.gaps(fp8, chosen).cpu())
                low_errors.append(self.logit_error(fp8, logits).cpu())
                del fp8
            del logits
        return (self.summary(served, own, errors),
                self.summary(low_gaps, low_own, low_errors) if control else None)

    def check(self, records: List[dict], limits: dict) -> dict:
        """The readings that the cell's limits name, each beside its limit."""
        got, _ = self.readings(records)
        return {k: {"value": got[k], "limit": c["limit"]} for k, c in limits.items()}
