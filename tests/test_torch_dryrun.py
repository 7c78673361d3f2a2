"""The dry run's tools on the CPU, in a fake world of 8 ranks (``(2, 4)``
over ``("data", "model")`` and ``(2, 2, 2)`` over ``("pod", "data",
"model")``, each case in a world its fixture makes and destroys), on the
reduced configs of minicpm-2b and granite-moe-3b-a800m, and of every arch
where a case says so:

* ``StepBundle.trace`` runs each kind of step on fake DTensors, launching
  no kernel (the launch counters stay) and allocating nothing: every kind
  of all ten archs, ``long_500k``'s batch of one included where ``cells``
  has it (its channels and ring rows folded over the data axes too);
* a fake world of 1 counts the FLOPs PyTorch's ``FlopCounterMode`` counts
  over the same step on plain tensors (recurrentgemma's and falcon-mamba's
  scans through their ops' formulas too); with every weight sharded,
  per-device FLOPs x 8 equal that; where the sequence-sharded fallback
  replicates the attention projections the ratio is above 1 (printed);
* the collective records, written as HLO lines, give the same wire bytes
  through the reference's ``collective_bytes_from_text`` as through the
  port's ``collective_bytes``;
* a 1-stage trace plus (2-stage - 1-stage) x (n_stages - 1) equals the
  whole model's FLOPs and wire bytes (``analyze_unrolled``'s assumption);
* the trace's peak bytes (``StepCounter``'s live storages) equal
  ``torch.distributed._tools.mem_tracker.MemTracker``'s peak over the same
  train step (the trace counts them itself: MemTracker's per-op walk over
  every live tensor costs minutes at full width), falcon-mamba's too;
* a rows-sharded ring-buffer cache's decode update moves at most (ranks
  on the row axes) x 1 row of k and of v over the wire;
* hill-climb's transforms give the reference's ``policy_for`` results;
* ``report``'s roofline table equals the reference's on the same JSON.
"""

import dataclasses
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.launch import report as r_report
from repro.launch.roofline import collective_bytes_from_text as r_collective_bytes_from_text
from repro.parallel import sharding as RS
from repro_torch.configs import ARCHS, cells
from repro_torch.launch import hillclimb, report
from repro_torch.launch.mesh import fake_world, make_local_mesh
from repro_torch.launch.roofline import analyze_unrolled, collective_bytes
from repro_torch.launch.steps import StepBundle
from repro_torch.parallel import policy_for

SHAPES = {"train": (16, 8, "train"), "prefill": (16, 8, "prefill"),
          "decode": (16, 8, "decode"), "long": (64, 1, "decode")}
MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
_HLO = {"float32": "f32", "bfloat16": "bf16", "float16": "f16", "int32": "s32", "int64": "s64"}


def _cfg(arch, **over):
    return dataclasses.replace(ARCHS[arch].reduced(), **over)


@pytest.fixture(params=sorted(MESHES))
def mesh(request):
    """A fake world of 8 laid out as the case's mesh, destroyed after it."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = MESHES[request.param]
    with fake_world(8):
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)


def _launches():
    mods = [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("flash_attention", "grouped_matmul", "lru_scan", "selective_scan")]
    return [(m.launches, getattr(m, "backward_launches", 0), getattr(m, "dx_launches", 0),
             getattr(m, "dw_launches", 0)) for m in mods]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-3b-a800m"])
def test_trace_runs_each_step_without_launching(mesh, arch, kind):
    before = _launches()
    t = StepBundle(_cfg(arch), mesh).trace(kind, SHAPES)
    assert _launches() == before
    assert not torch.cuda.is_available() or torch.cuda.memory_allocated() == 0
    assert t["kind"] == kind and t["flops"] > 0 and t["bytes"] > 0
    assert 0 < t["argument_bytes"] <= t["peak_bytes"]
    assert t["records"] and all(r["bytes"] > 0 for r in t["records"])
    coll = collective_bytes(t["records"])
    assert coll["total_bytes"] == pytest.approx(sum(coll["by_link"].values()))
    assert set(coll["by_axis"]) <= set(mesh.mesh_dim_names)


# the other eight archs' step kinds (minicpm's and granite's are
# test_trace_runs_each_step_without_launching's): each cell's kind
# (``long`` where it has ``long_500k``), train on the 2x4 mesh alone, the
# rest on both
_KINDS = {"train_4k": "train", "prefill_32k": "prefill", "decode_32k": "decode",
          "long_500k": "long"}
EVERY_CELL = [(arch, _KINDS[shape], mesh_name) for arch in sorted(ARCHS)
              if arch not in ("minicpm-2b", "granite-moe-3b-a800m")
              for shape in cells(ARCHS[arch])
              for mesh_name in (("2x4",) if shape == "train_4k" else sorted(MESHES))]


@pytest.mark.parametrize("arch,kind,mesh_name", EVERY_CELL)
def test_every_arch_traces_each_kind_without_launching(arch, kind, mesh_name):
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = MESHES[mesh_name]
    before = _launches()
    with fake_world(8):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        t = StepBundle(_cfg(arch), mesh).trace(kind, SHAPES)
    assert _launches() == before
    assert not torch.cuda.is_available() or torch.cuda.memory_allocated() == 0
    assert t["flops"] > 0 and 0 < t["argument_bytes"] <= t["peak_bytes"]
    assert t["policy"].batch_shardable == (kind != "long")
    coll = collective_bytes(t["records"])
    assert set(coll["by_axis"]) <= set(names)


def test_ring_update_moves_o_s_rows_a_rank():
    """One decode step's ring-buffer update of danube's cache (8 kv heads
    at TP 16, a fake world of 2 x 16: rows sharded over ``model``, 4,096 of
    them), for k and for v: each moves at most 16 ranks x 1 row x 8 kv
    heads x 120 x 2 bytes over the wire (each rank's first row,
    all-gathered), never the cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    import torch.distributed.tensor as dtensor

    from repro_torch.launch.roofline import StepCounter
    from repro_torch.models import meshed
    from repro_torch.models.meshed import mesh_context
    from repro_torch.parallel import placements

    cfg = ARCHS["h2o-danube-3-4b"]
    batch, hkv, hd, rows, tp = 8, cfg.eff_kv_heads, cfg.head_dim, cfg.window, 16
    with fake_world(2 * tp):
        mesh = init_device_mesh("cpu", (2, tp), mesh_dim_names=("data", "model"))
        pol = policy_for(cfg, mesh, batch=batch)
        spec = pol.spec("kv_cache")
        assert spec == (("data",), None, "model", None)
        counter = StepCounter(mesh)
        with FakeTensorMode(), mesh_context(pol):
            def empty(shape, sp):
                return dtensor.empty(shape, dtype=torch.bfloat16, device_mesh=mesh,
                                     placements=placements(sp, mesh))
            for _ in ("k", "v"):
                cache = empty((batch, hkv, rows, hd), spec)
                new = empty((batch, hkv, 1, hd), pol.spec("kv_heads"))
                with counter:
                    out = meshed.ring_update(cache, new, pol, spec)
                assert out.shape == cache.shape and out.placements == cache.placements
    wire = collective_bytes(counter.records)
    one_row = batch // 2 * hkv * hd * 2  # a row of a data rank's batch, bf16
    assert wire["counts"]["all-gather"] == 2 and wire["total_bytes"] > 0
    assert wire["total_bytes"] <= 2 * tp * 1 * one_row
    assert wire["total_bytes"] < rows // tp * one_row


@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-3b-a800m", "recurrentgemma-2b",
                                  "falcon-mamba-7b"])
def test_peak_bytes_equal_mem_tracker(mesh, arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch.steps import _locals, input_specs
    from repro_torch.models.meshed import mesh_context

    cfg = _cfg(arch)
    bundle = StepBundle(cfg, mesh)
    peak = bundle.trace("train", SHAPES)["peak_bytes"]
    pol = policy_for(cfg, mesh, batch=SHAPES["train"][1])
    with FakeTensorMode():
        params, args = bundle._fake_arguments("train", input_specs(cfg, "train", SHAPES), pol)
        with mesh_context(pol):
            tracker = MemTracker()
            tracker.track_external(params, *_locals(args))
            with tracker:
                bundle.train_step(params, *args)
    assert peak == max(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-3b-a800m", "recurrentgemma-2b",
                                  "falcon-mamba-7b"])
def test_one_rank_counts_what_the_flop_counter_counts(arch, kind):
    """A fake world of 1 counts the FLOPs ``FlopCounterMode`` counts over
    the same step on plain CPU tensors (none of DTensor's sharding
    propagation, which runs ops on global shapes, among them)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import init_cache, init_params
    from repro_torch.optim import adamw_init

    cfg = _cfg(arch)
    seq, batch, _ = SHAPES[kind]
    model = init_params(cfg, 0, device="cpu", tp_size=1)
    tokens = torch.randint(0, cfg.vocab, (batch, seq))
    bundle = StepBundle(cfg)
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            model.requires_grad_(True)
            bundle.train_step(model, adamw_init(model.param_tree()), tokens, tokens)
        else:
            bundle.prefill_step(model, tokens, init_cache(cfg, batch, seq, device="cpu"))
    assert _one_device_flops(cfg, kind) == counter.get_total_flops()


def _one_device_flops(cfg, kind):
    with fake_world(1):
        return StepBundle(cfg, make_local_mesh(device="cpu")).trace(kind, SHAPES)["flops"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flops_split_over_the_ranks(kind):
    """Heads and kv heads divide TP 4: every weight sharded, so 8 ranks
    each do an eighth. At 6 heads the attention is sequence-sharded and its
    projections run on every ``model`` rank: more than an eighth each."""
    from torch.distributed.device_mesh import init_device_mesh

    ratios = {}
    for name, over in (("sharded", {"n_kv_heads": 4}),
                       ("seq_sharded", {"n_heads": 6, "n_kv_heads": 6})):
        cfg = _cfg("minicpm-2b", **over)
        one = _one_device_flops(cfg, kind)
        with fake_world(8):
            per = StepBundle(cfg, init_device_mesh("cpu", (2, 4), mesh_dim_names=(
                "data", "model"))).trace(kind, SHAPES)["flops"]
        ratios[name] = per * 8 / one
    print(f"{kind}: per-device FLOPs x 8 / one device's = {ratios}")
    assert ratios["sharded"] == 1.0
    assert ratios["seq_sharded"] > 1.0


def _hlo_line(r):
    dims = ",".join(str(d) for d in r["shape"])
    layout = ",".join(str(i) for i in reversed(range(len(r["shape"]))))
    return f"  %c = {_HLO[r['dtype']]}[{dims}]{{{layout}}} {r['kind']}(%x), replica_groups={{}}"


@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-3b-a800m"])
def test_collective_bytes_match_the_reference_text_count(mesh, arch):
    t = StepBundle(_cfg(arch), mesh).trace("train", SHAPES)
    ours = collective_bytes(t["records"])
    theirs = r_collective_bytes_from_text("\n".join(_hlo_line(r) for r in t["records"]))
    assert theirs["counts"] == ours["counts"]
    for kind in theirs["counts"]:
        assert ours[kind] == theirs[kind], kind
    assert ours["total_bytes"] == theirs["total_bytes"]


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-3b-a800m"])
def test_stage_extrapolation_equals_the_whole_trace(mesh, arch, kind):
    cfg = _cfg(arch, n_layers=4)
    total, m1, m2 = analyze_unrolled(cfg, mesh, kind, SHAPES)
    t = StepBundle(cfg, mesh).trace(kind, SHAPES)
    assert m1["flops"] < m2["flops"]
    assert total["flops"] == t["flops"]
    assert total["wire"] == collective_bytes(t["records"])["total_bytes"]


def _stub(shape, names):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=object))


@pytest.mark.parametrize("cell", sorted(hillclimb.PLANS))
def test_hillclimb_transforms_give_the_reference_policies(cell):
    arch = cell.split("/")[0]
    cfg, rcfg = ARCHS[arch], R_ARCHS[arch]
    fields = ("dp", "tp", "shard_heads", "shard_kv_heads", "shard_experts", "seq_shard_attn",
              "tp_size", "dp_size", "batch_shardable")
    steps = [("baseline", lambda c: c)] + [(name, fn) for name, _, fn, _ in hillclimb.PLANS[cell]]
    seen = set()
    stub = _stub((16, 16), ("data", "model"))
    for name, transform in steps:
        cfg, rcfg = transform(cfg), transform(rcfg)
        ours, theirs = policy_for(cfg, stub), RS.policy_for(rcfg, stub)
        assert {f: getattr(ours, f) for f in fields} == \
            {f: getattr(theirs, f) for f in fields}, name
        seen.add((ours.shard_heads, ours.seq_shard_attn))
    if any(name.startswith("pad_heads") for name, _ in steps):  # padding un-does the fallback
        assert (False, True) in seen and (True, False) in seen
    assert all(p in ("nothing", "dots") for _, _, _, p in hillclimb.PLANS[cell])


def test_report_roofline_table_matches_the_reference(tmp_path, monkeypatch):
    rec = {"arch": "minicpm-2b", "shape": "train_4k", "compute_s": 0.5, "memory_s": 0.25,
           "collective_s": 1.5, "dominant": "collective", "useful_flops_fraction": 0.25}
    data = {"minicpm-2b|train_4k": rec,
            "granite-moe-3b-a800m|decode_32k": {**rec, "arch": "granite-moe-3b-a800m",
                                                "shape": "decode_32k",
                                                "useful_flops_fraction": None}}
    (tmp_path / "results").mkdir()
    path = tmp_path / "results" / "roofline.json"
    path.write_text(json.dumps(data))
    monkeypatch.setattr(r_report, "ROOT", tmp_path)
    assert report.roofline_table(path) == r_report.roofline_table()
