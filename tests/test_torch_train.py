"""The port's training path on the CPU against the reference's.

* ``loss_fn`` and its gradient for each of the ten configs, reduced and in
  float32, on the reference's weights carried across with
  ``params_from_numpy``: the port's loss and ``torch.autograd`` gradients
  (``loss_and_grads``, back in the reference's layout with
  ``tree_to_numpy``) against ``jax.value_and_grad(loss_fn)`` with the
  reference on its jnp oracles (the CPU backend never picks Pallas). Loss
  within 1e-5 relative; each leaf within 1e-4 of its largest entry's
  magnitude (XLA and torch sum in other orders across the layers, as the
  model tests' 1e-4 allows). ``remat=True`` gives the bits of
  ``remat=False``.
* The reference's ``TestTrainerFaultTolerance`` (``tests/test_substrate.py``)
  on the port's ``Trainer``: the loss falls, a crash and restart resumes
  bit for bit, training through the int8 gradient compression still
  learns, and the straggler hook fires.
* The trainer CLI (``python -m repro_torch.launch.train``, with resume),
  ``examples/torch_train_lm.py`` for 3 steps, ``StepBundle``, the H100
  roofline terms and the 6 N D count.
* The kernels around training: ``attention_ref``'s gradient is finite
  (0) on a row that sees no key, and its forward bits are the former
  ``nan_to_num`` version's; ``attention_bwd_ref`` and
  ``attention_lse_ref`` against autograd and ``logsumexp``; flash takes
  every width pair of its forward under grad (MLA's 192 / 128 too); the
  grouped GEMM, the RG-LRU scan and the selective scan's two entries go
  through their autograd Functions, whose backward names its C entry,
  with no fallback; every plain version stays differentiable on the CPU.
"""

import dataclasses
import importlib.util
import inspect
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.configs import ARCHS as R_ARCHS
from repro.models.transformer import FRONTEND_DIMS
from repro_torch.configs import ARCHS
from repro_torch.kernels import ref as TK
from repro_torch.launch import roofline
from repro_torch.launch.roofline_run import model_flops_per_device
from repro_torch.launch.steps import StepBundle
from repro_torch.models import (forward, init_params, loss_and_grads, loss_fn,
                                params_from_numpy)
from repro_torch.models.convert import tree_to_numpy
from repro_torch.optim import adamw_init
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves, tree_leaves_with_names

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 16


def _inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    if cfg.frontend:
        inputs = rng.randn(B, S, FRONTEND_DIMS[cfg.frontend]).astype(np.float32)
    else:
        inputs = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    return inputs, rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_and_grads_match_the_reference(name):
    cfg, rcfg = ARCHS[name].reduced(), R_ARCHS[name].reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0), tp_size=1)
    inputs, labels = _inputs(cfg, 1)
    rloss, rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(p, rcfg, jnp.asarray(inputs), jnp.asarray(labels)))(rparams)
    model = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    model.requires_grad_(True)
    loss, grads = loss_and_grads(model, cfg, torch.from_numpy(inputs), torch.from_numpy(labels))
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    mine = tree_leaves_with_names(tree_to_numpy(grads))
    theirs = tree_leaves_with_names(jax.tree.map(np.asarray, rgrads))
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (leaf, got), (_, want) in zip(mine, theirs):
        assert got.shape == want.shape, leaf
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=leaf)
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("name", ["minicpm-2b", "granite-moe-3b-a800m", "recurrentgemma-2b",
                                  "falcon-mamba-7b", "deepseek-v2-236b"])
def test_remat_gives_the_bits_of_no_remat(name):
    cfg = ARCHS[name].reduced()
    model = init_params(cfg, 0, device="cpu", tp_size=1).requires_grad_(True)
    inputs, labels = (torch.from_numpy(a) for a in _inputs(cfg, 2))
    a_loss, a_grads = loss_and_grads(model, cfg, inputs, labels, remat=True)
    b_loss, b_grads = loss_and_grads(model, cfg, inputs, labels, remat=False)
    assert torch.equal(a_loss, b_loss)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a_grads), tree_leaves(b_grads)))
    with torch.no_grad():  # no autograd record: remat runs nothing differently
        assert torch.equal(forward(model, cfg, inputs), forward(model, cfg, inputs, remat=False))


def test_loss_masks_the_padded_vocab():
    cfg = dataclasses.replace(ARCHS["minicpm-2b"].reduced(), vocab=250)  # padded to 256
    model = init_params(cfg, 0, device="cpu")
    inputs, labels = (torch.from_numpy(a % 250) for a in _inputs(cfg, 3))
    with torch.no_grad():
        logits = forward(model, cfg, inputs)[..., :250]
        want = torch.mean(torch.logsumexp(logits, -1)
                          - torch.gather(logits, -1, labels.long()[..., None])[..., 0])
        assert float(loss_fn(model, cfg, inputs, labels)) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# The Trainer (the reference's TestTrainerFaultTolerance, on the port)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_cfg():
    cfg = ARCHS["h2o-danube-3-4b"].reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=32, d_ff=64, vocab=128,
                               n_heads=2, n_kv_heads=1, head_dim=16)


class TestTrainerFaultTolerance:
    def test_loss_decreases(self, tiny_cfg, tmp_path):
        t = Trainer(tiny_cfg, TrainerConfig(seq_len=16, batch=4, total_steps=60,
                                            checkpoint_every=30, lr=5e-3),
                    tmp_path / "ck", device="cpu")
        metrics = t.run()
        first = np.mean([m["loss"] for m in metrics[:10]])
        last = np.mean([m["loss"] for m in metrics[-10:]])
        assert last < first, (first, last)

    def test_crash_restart_resumes_exactly(self, tiny_cfg, tmp_path):
        tc = TrainerConfig(seq_len=16, batch=4, total_steps=40, checkpoint_every=10, lr=5e-3)
        ref = Trainer(tiny_cfg, tc, tmp_path / "a", device="cpu").run()
        t1 = Trainer(tiny_cfg, tc, tmp_path / "b", fail_at_step=25, device="cpu")
        with pytest.raises(RuntimeError, match="injected failure"):
            t1.run()
        t2 = Trainer(tiny_cfg, tc, tmp_path / "b", device="cpu")
        assert t2.start_step == 20  # resumed after the last checkpoint
        resumed = t2.run()
        ref_tail = {m["step"]: m["loss"] for m in ref if m["step"] >= 20}
        res_tail = {m["step"]: m["loss"] for m in resumed}
        assert sorted(res_tail) == sorted(ref_tail)
        for step, loss in res_tail.items():
            assert loss == ref_tail[step], step  # bit for bit: one device, one order

    def test_grad_compression_still_learns(self, tiny_cfg, tmp_path):
        t = Trainer(tiny_cfg, TrainerConfig(seq_len=16, batch=4, total_steps=60,
                                            checkpoint_every=60, lr=5e-3,
                                            grad_compression=True),
                    tmp_path / "ck", device="cpu")
        metrics = t.run()
        assert np.mean([m["loss"] for m in metrics[-10:]]) < np.mean(
            [m["loss"] for m in metrics[:10]])

    def test_straggler_hook_fires(self, tiny_cfg, tmp_path):
        seen = []
        t = Trainer(tiny_cfg, TrainerConfig(seq_len=16, batch=4, total_steps=20,
                                            checkpoint_every=20, straggler_factor=1.5),
                    tmp_path / "ck", on_straggler=lambda s, r: seen.append(s), device="cpu")
        orig = t.pipeline.next_batch

        def slow_batch():
            if t.pipeline.cursor.step == 15:
                time.sleep(0.5)
            return orig()

        t.pipeline.next_batch = slow_batch
        t.run()
        assert 15 in t.straggler_steps and 15 in seen  # the watchdog saw the slow fetch


def test_trainer_default_device_needs_a_card(tiny_cfg, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tiny_cfg, TrainerConfig(), tmp_path / "ck")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_launch_train_cli_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch.train import main

    args = ["--arch", "minicpm-2b", "--smoke", "--seq", "16", "--batch", "2", "--device", "cpu",
            "--ckpt", str(tmp_path / "ck")]
    main(args + ["--steps", "2"])
    main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "step 0: loss" in out and "resumed at step 2" in out and "step 3: loss" in out
    assert out.count("done; checkpoint saved") == 2


def test_example_trains_three_steps(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("torch_train_lm",
                                                  ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["3", "--device", "cpu", "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "params=" in out and "final loss" in out
    assert (tmp_path / "ck" / "LATEST").read_text() == "2"


def test_step_bundle_trains_in_place():
    cfg = ARCHS["minicpm-2b"].reduced()
    model = init_params(cfg, 0, device="cpu", tp_size=1).requires_grad_(True)
    opt = adamw_init(model.param_tree())
    before = [p.detach().clone() for p in model.parameters()]
    bundle = StepBundle(cfg, lr=1e-2)
    inputs, labels = (torch.from_numpy(a) for a in _inputs(cfg, 4))
    losses = []
    for _ in range(3):
        params, opt, m = bundle.train_step(model, opt, inputs, labels)
        assert params is model and bool(torch.isfinite(m["gnorm"]))
        losses.append(float(m["loss"]))
    assert int(opt["step"]) == 3 and losses[-1] < losses[0]
    assert not any(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    cache = __import__("repro_torch.models", fromlist=["init_cache"]).init_cache(
        cfg, 2, 32, device="cpu")
    logits, cache = bundle.prefill_step(model, inputs, cache)
    logits, _ = bundle.decode_step(model, inputs[:, :1], cache, S)
    assert logits.shape == (2, 1, 256) and not logits.requires_grad


def _reference_model_flops():
    """The reference's ``model_flops_per_device``. Its module sets
    ``XLA_FLAGS`` (512 host devices) when imported; the variable is put
    back at once, so that no later test in this process meets a JAX
    backend of 512 devices."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.roofline_run import model_flops_per_device as fn
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return fn


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_model_flops_match_the_reference(name):
    r_model_flops = _reference_model_flops()
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert model_flops_per_device(ARCHS[name], shape, 256) == \
            r_model_flops(R_ARCHS[name], shape, 256)


def test_roofline_terms_on_the_h100():
    terms = roofline.roofline_terms(989e12, 3.35e12, 450e9, model_flops=494.5e12)
    assert (terms.compute_s, terms.memory_s, terms.collective_s) == (1.0, 1.0, 1.0)
    assert terms.useful_flops_fraction == 0.5 and terms.step_time_s == 1.0
    mf = model_flops_per_device(ARCHS["minicpm-2b"], "step",
                                1, shapes={"step": (512, 4, "train")})
    assert mf == 6 * ARCHS["minicpm-2b"].n_params * 2048
    assert roofline.roofline_terms(mf, 0, 0).as_dict()["dominant"] == "compute"


# ---------------------------------------------------------------------------
# The kernels around training, on the CPU
# ---------------------------------------------------------------------------

def _old_attention_ref(q, k, v, **flags):
    """attention_ref as it was before the NaN guard: nan_to_num after the
    softmax."""
    s, mask = TK._scores(q, k, **{"causal": True, "window": None, "softcap": None,
                                  "scale": None, "q_offset": 0, "prefix_len": 0, **flags})
    p = torch.nan_to_num(torch.softmax(s.masked_fill(~mask, float("-inf")), -1), nan=0.0)
    b, h, sq, _ = q.shape
    return torch.einsum("bkgql,bkld->bkgqd", p, v.float()).reshape(b, h, sq, -1).to(q.dtype)


ATTN_CASES = [((2, 4, 2, 37, 37, 16), {}),
              ((1, 4, 1, 20, 33, 8), {"window": 7, "softcap": 5.0, "prefix_len": 3}),
              ((1, 2, 2, 9, 9, 8), {"q_offset": -4}),
              ((1, 2, 1, 6, 10, 8), {"causal": False, "window": 3})]


@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_attention_ref_gradient_and_backward_formulas(case):
    (b, h, hkv, sq, sk, d), flags = ATTN_CASES[case]
    rng = np.random.RandomState(case)
    q, k, v = (torch.from_numpy(rng.randn(b, n, s, d).astype(np.float32)).requires_grad_(True)
               for n, s in ((h, sq), (hkv, sk), (hkv, sk)))
    out = TK.attention_ref(q, k, v, **flags)
    assert torch.equal(out, _old_attention_ref(q, k, v, **flags))  # the same forward bits
    do = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    out.backward(do)
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    lse = TK.attention_lse_ref(q.detach(), k.detach(), **flags)
    got = TK.attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), lse, do,
                               **flags)
    for g, t in zip(got, (q, k, v)):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-5)
    if flags.get("q_offset", 0) < 0:  # blind rows: 0 out, 0 gradient, lse -inf
        blind = -flags["q_offset"]
        assert bool((out[:, :, :blind] == 0).all()) and bool((q.grad[:, :, :blind] == 0).all())
        assert bool(torch.isneginf(lse[:, :, :blind]).all())


def test_flash_wrapper_is_differentiable_on_the_cpu():
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    fa.flash_attention(q, q.detach(), q.detach(), q_offset=-3).sum().backward()
    assert bool(torch.isfinite(q.grad).all()) and fa.kernel_takes(64, 64)
    assert fa.kernel_takes(128, 128) and fa.kernel_takes(256, 256)
    assert not fa.kernel_takes(264, 264) and fa.kernel_takes(192, 128)
    assert not fa.kernel_takes(200, 128) and not fa.kernel_takes(192, 136)
    assert not hasattr(fa, "backward_takes")  # one rule for both directions
    src = inspect.getsource(fa.flash_attention)
    route = "torch.ops.repro_torch.flash_attention_lse.default("
    assert route in src and "raise" not in src.split(route)[0].split("is_grad_enabled")[1]
    out = fa.flash_attention(q, q.detach(), q.detach())
    assert type(out.grad_fn).__name__ == (
        "GeneratedBackwardFor_repro_torch_flash_attention_lse_defaultBackward")
    assert "flash_attention_bwd.default(" in inspect.getsource(fa._lse_backward)


# name -> (module, the wrapper's route: a Function or a torch.library op, the
# function its backward calls (for an op: the op's autograd backward, the
# backward op it calls and that op's CUDA kernel), the C entries that
# backward reaches, where they are named).
BACKWARDS = {
    "grouped_matmul": ("grouped_matmul", "torch.ops.repro_torch.grouped_matmul_fwd.default",
                       ("_fwd_backward", "grouped_matmul_bwd", "_gmm_bwd_op"),
                       ("acs_grouped_matmul_dx", "acs_grouped_matmul_dw"),
                       "grouped_matmul_bwd"),
    "lru_scan": ("lru_scan", "torch.ops.repro_torch.lru_scan.default",
                 ("_scan_backward", "lru_scan_bwd", "_scan_bwd_cuda"), ("acs_lru_scan_bwd",),
                 "_backward"),
    "selective_scan": ("selective_scan", "_SelectiveScanFunction", "selective_scan_bwd",
                       ("acs_mamba_scan_bwd",), "_backward"),
    "mamba_scan": ("selective_scan", "torch.ops.repro_torch.mamba_scan.default",
                   ("_mamba_backward", "mamba_scan_bwd", "_mamba_bwd_cuda"),
                   ("acs_mamba_scan_bwd",), "_backward"),
}


@pytest.mark.parametrize("name", sorted(BACKWARDS))
def test_backward_kernels_replace_refuse_grad(name):
    """Every wrapper has a backward kernel: no module calls a guard that
    refuses grad (``_nvcc.refuse_grad`` is gone), and under grad both
    devices go through the autograd Function or the op's registered
    autograd, whose backward is the module's backward op or ``<name>_bwd``:
    on a CUDA tensor its hand-written entries, with no ``try`` that could
    fall back to the plain version."""
    module, route, bwd_fn, entries, holder = BACKWARDS[name]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    text = inspect.getsource(mod)
    assert "refuse_grad" not in text
    assert not hasattr(importlib.import_module("repro_torch.kernels._nvcc"), "refuse_grad")
    src = inspect.getsource(getattr(mod, name))
    if route.startswith("torch.ops."):  # a torch.library op and its registered autograd
        autograd_fn, bwd_op, cuda_fn = bwd_fn
        assert f"{route}(" in src
        assert f".register_autograd({autograd_fn}, " in text
        assert f"torch.ops.repro_torch.{bwd_op}.default(" in inspect.getsource(
            getattr(mod, autograd_fn))
        # the backward op's CUDA kernel: a function registered for it, or
        # the op's own body where it takes both devices
        assert (f'.register_kernel("cuda")\ndef {cuda_fn}(' in text
                or f'device_types=("cpu", "cuda"))\ndef {cuda_fn}(' in text)
        kernel = getattr(mod, cuda_fn)
        bwd = inspect.getsource(getattr(kernel, "_init_fn", kernel))
    else:
        assert f"{route}.apply" in src
        assert src.index("torch.is_grad_enabled()") < src.index(f"{route}.apply")
        assert f"{bwd_fn}(" in inspect.getsource(getattr(mod, route).backward)
        bwd = inspect.getsource(getattr(mod, bwd_fn))
    assert f"{holder}(" in bwd
    launch = inspect.getsource(getattr(mod, holder))
    assert all(entry in launch for entry in entries)
    assert all("try:" not in t and "except" not in t for t in (bwd, launch))


def test_plain_versions_stay_differentiable_on_the_cpu():
    from repro_torch.kernels import ops

    a = torch.rand(1, 5, 4, requires_grad=True)
    ops.lru_scan(a, torch.rand(1, 5, 4), torch.zeros(1, 4)).sum().backward()
    assert a.grad is not None
    w = torch.randn(2, 8, 4, requires_grad=True)
    ops.grouped_matmul(torch.randn(8, 8), w, torch.tensor([0, 1], dtype=torch.int32),
                       block_m=4).sum().backward()
    assert w.grad is not None and bool((w.grad != 0).all())
    dt = torch.rand(1, 5, 4, requires_grad=True)
    ys, _ = ops.selective_scan(dt, torch.rand(1, 5, 4), torch.rand(1, 5, 2), torch.rand(1, 5, 2),
                               -torch.rand(4, 2), torch.zeros(1, 4, 2))
    ys.sum().backward()
    assert dt.grad is not None


def test_backward_width_comes_from_the_wrapper():
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    assert f"-DACS_FLASH_BWD_MAX_D={fa.MAX_BACKWARD_HEAD_DIM}" in fa._BACKWARD_LIB.flags
    src = fa.BACKWARD_SOURCE.read_text()
    assert "constexpr int kMaxD = ACS_FLASH_BWD_MAX_D;" in src
    assert "#error" in src and "defined(ACS_FLASH_BWD_MAX_D)" in src


# C entry point -> (its wrapper module, its source's attribute there, the
# binder's name there): flash's three libraries, and the grouped GEMM's and
# the RG-LRU scan's forward and backward entries, which share a library.
ENTRIES = {"acs_flash_attention": ("flash_attention", "SOURCE", "_bind"),
           "acs_flash_attention_bwd": ("flash_attention", "BACKWARD_SOURCE", "_bind_backward"),
           "acs_flash_attention_bwd_wgmma": ("flash_attention", "BACKWARD_WGMMA_SOURCE",
                                             "_bind_backward_wgmma"),
           "acs_grouped_matmul": ("grouped_matmul", "SOURCE", "_bind"),
           "acs_grouped_matmul_dx": ("grouped_matmul", "SOURCE", "_bind"),
           "acs_grouped_matmul_dw": ("grouped_matmul", "SOURCE", "_bind"),
           "acs_lru_scan": ("lru_scan", "SOURCE", "_bind"),
           "acs_lru_scan_bwd": ("lru_scan", "SOURCE", "_bind")}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_flash_entry_points_bind_every_argument(entry):
    """Each C entry point's parameters, counted in its source, match the
    ``argtypes`` the wrapper binds (a missing pointer would shift every
    later argument): flash's, and the training path's other entries."""
    import ctypes
    import re

    module, source_attr, binder = ENTRIES[entry]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    text = getattr(mod, source_attr).read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1)

    class Lib:
        pass

    lib = Lib()
    for name in re.findall(r'extern "C" int (\w+)\(', text):
        setattr(lib, name, type("Fn", (), {})())
    getattr(mod, binder)(lib)
    argtypes = getattr(lib, entry).argtypes
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.split()[0] == "float"
             else ctypes.c_int for p in (part.strip() for part in params.split(","))]
    assert argtypes == kinds
