"""A train cell: the program's production train step, ``StepBundle(cfg,
lr, clip).train_step`` from ``repro_torch.launch.steps``, in a closed loop.

Set-up makes the weights from the seed on the device (the reference's
layout, each leaf copied into the program's model as
``models.init_params`` lays it out), the AdamW state with
``optim.adamw_init``, and every batch the window can use. Each step runs
at the learning rate the traffic's schedule gives the job's step of that
number (``reference.model.Optimizer.lr_at``). The first ``check_steps``
steps are the warm-up and the steps the reference follows: after the
first, each leaf's first gradient is read back from AdamW's m; after the
last, each leaf's change of its master weights. Set-up ends with a full
garbage collection and ``gc.freeze()``, so that the window's collections
do not walk what set-up made. The window runs steps back to back, each
ended by the host read of its loss and gradient norm, until ``--seconds``
have passed. A traced run wraps the step's calls in spans, records the
window's device operations (``devtrace.WindowTrace``), and after the
window profiles a few more steps with their operators' shapes. Once the
peak memory is read, the program's state is freed and the reference runs
the same first steps on the same weights and batches, a layer at a time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import math
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import compare
from ..reference.model import Leaf, Optimizer, Spec, layout, run_steps
from ..weights import iter_weights, make_batches, make_weights

__all__ = ["Cell", "Result", "Program", "run", "reference_readings", "program_arch",
           "to_program_name"]

SPANNED = ("loss_and_grads", "clip_by_global_norm", "adamw_update")


@dataclasses.dataclass
class Cell:
    """What one run of a train cell needs: the configuration and traffic
    files' objects, and the run's arguments."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    sizes: Dict[str, Any] = dataclasses.field(default_factory=dict)  # tests' tiny models
    log: Callable[[str], None] = lambda msg: None


@dataclasses.dataclass
class Result:
    """What the harness reports of a run (any kind's run gives these):
    the end-to-end metrics the kind measured (the harness leaves out one it
    did not), the numbers compared, each ``(value, limit)``, and what a
    reader of a failed run needs besides (``checks``)."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    correct: bool
    compared: Dict[str, Tuple[float, float]]
    checks: Dict[str, Any]
    memory_peak_bytes: int
    setup_end: float                # ``time.perf_counter()`` at the window's start
    run: Optional[Any] = None       # the traced run's readings for the per-layer metrics
    busy_s: Optional[float] = None  # device-busy seconds of the traced window


def program_arch(cell: Cell, spec: Spec):
    """The program's ``ArchConfig`` for the configuration, checked against
    the file's description (or cut to the tests' tiny sizes)."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[cell.config["program_arch"]]
    want = dict(n_layers=spec.n_layers, d_model=spec.d_model, n_heads=spec.n_heads,
                n_kv_heads=spec.n_kv_heads, head_dim=spec.head_dim, vocab=spec.vocab,
                tied_embeddings=spec.tied, embed_scale=spec.embed_scale is not None,
                norm_eps=spec.norm_eps, rope_theta=spec.rope_theta, dtype=spec.dtype)
    if not spec.moe:
        want["d_ff"] = spec.d_ff
    if cell.sizes:
        cfg = dataclasses.replace(cfg, **want)
        if spec.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_experts=spec.n_experts, top_k=spec.top_k, d_expert=spec.d_expert))
    have = {k: getattr(cfg, k) for k in want}
    if spec.moe:
        m = cfg.moe
        have.update(n_experts=m.n_experts, top_k=m.top_k, d_expert=m.d_expert,
                    capacity_factor=m.capacity_factor, n_shared=m.n_shared,
                    dispatch_groups=m.dispatch_groups, first_dense=m.first_dense)
        want.update(n_experts=spec.n_experts, top_k=spec.top_k, d_expert=spec.d_expert,
                    capacity_factor=spec.capacity_factor, n_shared=0, dispatch_groups=1,
                    first_dense=0)
    elif cfg.moe is not None:
        have["moe"], want["moe"] = cfg.moe, None
    bad = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if bad or cfg.frontend or set(cfg.pattern_unit) != {"attn_global"} or cfg.window:
        raise ValueError(f"the program's {cfg.name} is not the configuration file's model: "
                         f"{bad or 'its layers'}")
    return cfg


def to_program_name(name: str, n_prefix: int, unit: int) -> str:
    """A reference leaf name (``layers.<i>.attn.wq``) as the program's
    parameter name (``stages.<s>.<u>.mixer.wq`` or ``prefix.<i>...``)."""
    m = re.fullmatch(r"layers\.(\d+)\.(.+)", name)
    if m is None:
        return name
    i, rest = int(m.group(1)), m.group(2).replace("attn.", "mixer.", 1)
    if i < n_prefix:
        return f"prefix.{i}.{rest}"
    s, u = divmod(i - n_prefix, unit)
    return f"stages.{s}.{u}.{rest}"


def _named(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A tree of ``param_tree``'s layout as ``{dotted name: tensor}``."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(_named(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _filled(tree: Any, values: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by ``values[its dotted name]``."""
    if isinstance(tree, dict):
        return {k: _filled(v, values, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_filled(v, values, f"{prefix}.{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return values.pop(prefix)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(tensors: List[torch.Tensor]) -> List[float]:
    """Each tensor's float32 norm, read back in one transfer."""
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).tolist()


def _check_optimizer(opt: Optimizer) -> None:
    """The traffic's AdamW constants are the ones the program's step uses
    (``adamw_update``'s defaults: the step passes only lr and the clip)."""
    from repro_torch.optim import adamw_update

    defaults = {k: p.default for k, p in inspect.signature(adamw_update).parameters.items()
                if p.default is not inspect.Parameter.empty}
    want = {"b1": opt.b1, "b2": opt.b2, "eps": opt.eps, "weight_decay": opt.weight_decay}
    if any(defaults.get(k) != v for k, v in want.items()):
        raise ValueError(f"the traffic's AdamW {want} is not the program's {defaults}")


class _Spans:
    """The benchmark's own spans around the calls ``launch.steps`` makes:
    each of ``SPANNED`` that the module still calls is wrapped in a
    profiler range and a pair of CUDA events while installed."""

    def __init__(self, module) -> None:
        self.module = module
        self.events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {}
        self.saved: Dict[str, Callable] = {}

    def _wrap(self, name: str, fn: Callable) -> Callable:
        record = self.events.setdefault(name, [])

        def spanned(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(f"acsbench.{name}"):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            record.append((start, end))
            return out

        return spanned

    def __enter__(self) -> "_Spans":
        for name in SPANNED:
            fn = getattr(self.module, name, None)
            if callable(fn):
                self.saved[name] = fn
                setattr(self.module, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc) -> None:
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)
        self.saved.clear()

    def clear(self) -> None:
        for record in self.events.values():
            record.clear()

    def device_ms(self) -> Dict[str, List[float]]:
        """Per step: each span's device ms, and ``optim`` from the clip's
        start to AdamW's end (read after a synchronize)."""
        out = {n: [s.elapsed_time(e) for s, e in pairs] for n, pairs in self.events.items()
               if pairs}
        clip, adam = self.events.get("clip_by_global_norm"), self.events.get("adamw_update")
        if clip and adam and len(clip) == len(adam):
            out["optim"] = [c[0].elapsed_time(a[1]) for c, a in zip(clip, adam)]
        return out


@dataclasses.dataclass
class TrainRun:
    """The traced run's readings, which the per-layer metrics read."""

    spec: Spec
    leaves: List[Leaf]
    batch: int
    seq: int
    steps: int
    window_s: float
    host_step_ms: List[float]
    span_ms: Dict[str, List[float]]
    busy_s: Optional[float] = None  # the window's device-busy seconds (WindowTrace)
    profile: Any = None             # the steps profiled after the window


def _change_norms(master: Dict[str, torch.Tensor], leaves: List[Leaf], seed: int,
                  device) -> Dict[str, float]:
    """Each leaf's norm of ``master - its initial value`` (made again from
    the seed), read back in one transfer."""
    names, norms = [], []
    for name, init in iter_weights(leaves, seed, device):
        names.append(name)
        norms.append(torch.linalg.vector_norm(master[name].float() - init.float()))
    return dict(zip(names, torch.stack(norms).tolist()))


def reference_readings(spec: Spec, leaves: List[Leaf], seed: int, device,
                       batches, opt: Optimizer, precision: str = "fp32") -> Dict[str, Any]:
    """The reference's (or, at ``precision="fp8"``, the control's) readings
    of the first steps, from the seed's weights."""
    params = {name: t.float() for name, t in iter_weights(leaves, seed, device)}
    losses, first = run_steps(spec, opt, params, batches, precision)
    return {"losses": losses, "grad_norms": first,
            "change_norms": _change_norms(params, leaves, seed, device)}


class Program:
    """The program's side of a run: its model and AdamW state made from the
    seed's weights, its step bundle, and the batches the run can use."""

    def __init__(self, cell: Cell) -> None:
        from repro_torch.launch.steps import StepBundle
        from repro_torch.models import init_params, split_pattern
        from repro_torch.models.transformer import LanguageModel
        from repro_torch.optim import adamw_init

        self.cell = cell
        dev, traffic = cell.device, cell.traffic
        model_sizes = {k: v for k, v in cell.sizes.items() if k not in ("batch", "seq")}
        self.spec = spec = Spec.from_config(cell.config, **model_sizes)
        cfg = program_arch(cell, spec)
        self.opt = Optimizer.from_traffic(traffic["optimizer"])
        _check_optimizer(self.opt)
        self.batch = cell.sizes.get("batch", traffic["batch"])
        self.seq = cell.sizes.get("seq", traffic["seq"])
        self.leaves = layout(spec)
        prefix, _ = split_pattern(cfg)
        self.names = {leaf.name: to_program_name(leaf.name, len(prefix), len(cfg.pattern_unit))
                      for leaf in self.leaves}
        meta = init_params(cfg, device="meta", tp_size=1)
        shapes = {n: (tuple(p.shape), p.dtype) for n, p in meta.named_parameters()}
        weights = make_weights(self.leaves, cell.seed, dev)
        mine = {self.names[n]: (tuple(t.shape), t.dtype) for n, t in weights.items()}
        if mine != shapes:
            diff = sorted(set(mine.items()) ^ set(shapes.items()), key=str)[:6]
            raise ValueError(f"the reference's layout is not the program's: {diff}")
        self.model = LanguageModel(cfg, _filled(meta.param_tree(),
                                                {self.names[n]: t for n, t in weights.items()}))
        del weights, meta
        self.model.requires_grad_(True)
        self.opt_state = adamw_init(self.model.param_tree())
        self.bundle = StepBundle(cfg, lr=self.opt.lr_at(1), clip=self.opt.clip)
        self.n_batches = max(traffic["batches"],
                             traffic["check_steps"] + traffic["profile_steps"] + 2)
        self.inputs, self.labels = make_batches(traffic["tokens"], spec.vocab, self.n_batches,
                                                self.batch, self.seq, cell.seed, dev)
        self.done = 0
        _sync(dev)

    def step(self):
        """The job's next train step, on the next batch at the schedule's
        learning rate; the step's device scalars."""
        j = self.done % self.n_batches
        self.done += 1
        self.bundle.lr = self.opt.lr_at(self.done)
        _, _, out = self.bundle.train_step(self.model, self.opt_state, self.inputs[j],
                                           self.labels[j])
        return out

    def first_steps(self) -> Dict[str, Any]:
        """The first ``check_steps`` steps, and the program's readings of
        them: each loss, each leaf's first gradient as AdamW got it (from m
        after one step, ``m = (1 - b1) g``), each leaf's change of its
        master weights."""
        m_state, master = _named(self.opt_state["m"]), _named(self.opt_state["master"])
        losses, grad_norms, t0 = [], {}, time.perf_counter()
        for i in range(self.cell.traffic["check_steps"]):
            losses.append(float(self.step()["loss"]))
            if i == 0:
                self.first_step_s = time.perf_counter() - t0
                got = _norms([m_state[self.names[n]] for n in self.names])
                grad_norms = {n: g / (1.0 - self.opt.b1) for n, g in zip(self.names, got)}
        change = _change_norms({n: master[self.names[n]] for n in self.names}, self.leaves,
                               self.cell.seed, self.cell.device)
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

    def free(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Drop the program's state; returns the first steps' batches."""
        n = self.cell.traffic["check_steps"]
        first = [(self.inputs[i].clone(), self.labels[i].clone()) for i in range(n)]
        del self.model, self.opt_state, self.bundle, self.inputs, self.labels
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()
        return first


def _edges(xs: List[float], k: int = 3) -> str:
    """The first and the last ``k`` of a run's per-step readings."""
    return f"{[round(x, 1) for x in xs[:k]]} .. {[round(x, 1) for x in xs[-k:]]}"


def run(cell: Cell) -> Result:
    from repro_torch.launch import steps as steps_module

    from .. import devtrace

    dev, log, traffic = cell.device, cell.log, cell.traffic
    limits = cell.config.get("limits") or {}
    traced = cell.trace and dev.type == "cuda"
    prog = Program(cell)
    program = prog.first_steps()
    log(f"first step {prog.first_step_s:.3f} s; learning rates of the first steps "
        f"{[prog.opt.lr_at(i + 1) for i in range(traffic['check_steps'])]}")
    _sync(dev)
    peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    gc.collect()
    gc.freeze()
    full_gc = gc.get_stats()[2]["collections"]
    with contextlib.ExitStack() as stack:
        spans = stack.enter_context(_Spans(steps_module)) if traced else None
        window = (stack.enter_context(devtrace.WindowTrace(lambda: prog.step()["loss"]))
                  if traced else None)
        if spans is not None:
            spans.clear()
        # -- the window -----------------------------------------------------
        host_ms, ends, failed, n = [], [], 0, 0
        setup_end = time.perf_counter()
        while True:
            h0 = time.perf_counter()
            out = prog.step()
            host_ms.append((time.perf_counter() - h0) * 1e3)
            loss, gnorm = float(out["loss"]), float(out["gnorm"])
            failed += not (math.isfinite(loss) and math.isfinite(gnorm))
            n += 1
            ends.append(time.perf_counter())
            if ends[-1] - setup_end >= cell.seconds:
                break
        window_s = ends[-1] - setup_end
        full_gc = gc.get_stats()[2]["collections"] - full_gc
        gc.unfreeze()
        busy_s = window.close() if window is not None else None
        _sync(dev)
        peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        span_ms, profile = {}, None
        if spans is not None:  # a few more steps under the profiler, after the window
            span_ms = spans.device_ms()
            spans.clear()
            log(f"window trace: {window.events} device events, busy {busy_s:.3f} s of "
                f"{window_s:.3f}; busy share by quarter of the trace "
                f"{[round(q, 4) for q in window.quarters]}; the top operations' shares of "
                f"each quarter's device time "
                f"{ {n[:150]: [round(x, 4) for x in v] for n, v in window.top_shares.items()} }; "
                f"fwd_bwd ms of the first and last steps "
                f"{_edges(span_ms.get('loss_and_grads', []))}")
            profile = devtrace.profile_steps(lambda i: float(prog.step()["loss"]),
                                             traffic["profile_steps"])
            calls: Dict[str, int] = {}
            for op in profile.ops:
                calls[op.name] = calls.get(op.name, 0) + 1
            log(f"profiled {profile.steps} steps: {len(profile.kernels)} device events, "
                f"{profile.busy_per_step_s * 1e3:.3f} ms of device time a step; calls {calls}")
    tokens = prog.batch * prog.seq
    end_to_end = {"train_tokens_per_s": n * tokens / window_s,
                  "train_peak_mem_gib": peak_window / 2 ** 30}
    walls = [(b - a) * 1e3 for a, b in zip([setup_end] + ends, ends)]
    log(f"window: {n} steps of {tokens} tokens in {window_s:.3f} s, {failed} failed; step "
        f"walls ms {_edges(walls)}, median {sorted(walls)[len(walls) // 2]:.1f}; "
        f"{full_gc} full garbage collections; last learning rate {prog.bundle.lr:.4g}; "
        f"first losses {program['losses']}")

    # -- free the program's state, then the reference ----------------------
    del out
    first = prog.free()
    t_ref = time.perf_counter()
    ref = reference_readings(prog.spec, prog.leaves, cell.seed, dev, first, prog.opt)
    found = compare.gaps(program, ref)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s; losses {ref['losses']}")
    run_info = TrainRun(spec=prog.spec, leaves=prog.leaves, batch=prog.batch, seq=prog.seq,
                        steps=n, window_s=window_s, host_step_ms=host_ms, span_ms=span_ms,
                        busy_s=busy_s, profile=profile)
    checks = {k: found[k] for k in ("left_out", "grad_gap_at", "change_gap_at", "loss_gaps")}
    checks.update(losses=program["losses"], reference_losses=ref["losses"])
    return Result(end_to_end=end_to_end, attempted=n, failed=failed,
                  correct=failed == 0 and compare.verdict(found, limits),
                  compared={k: (found[k], v) for k, v in limits.items()}, checks=checks,
                  memory_peak_bytes=max(peak_setup, peak_window), setup_end=setup_end,
                  run=run_info, busy_s=busy_s)
