"""The sharded step on a mesh against one process, on the CPU.

A ``gloo`` world of 4 processes (``tests/_torch_mesh_step_worker.py``,
a ``FileStore`` under ``tmp_path``, no port) lays a 2 x 2 ``("data",
"model")`` mesh out and runs ``StepBundle``'s train, prefill and decode
steps over DTensors placed by the port's specs; this process runs the
same steps on plain tensors. In float32, on the reference's weights
carried across, for:

* reduced minicpm at 3 heads, which TP 2 does not divide: the
  sequence-sharded attention fallback (each rank's query rows, its
  ``q_offset`` shifted, against k and v gathered whole; the cache rows
  sharded, decode's softmax combined across the ranks);
* the same padded to 4 heads (``pad_heads_to``): heads sharded, flash on
  its op's sharding rule;
* reduced granite: its experts sharded over ``model`` (each rank's own,
  tile ids rebased; the combine summed across ``model``), heads sharded;
* reduced granite at one kv head: query heads sharded, each rank taking
  the kv head its heads read;
* reduced granite routing within 2 dispatch groups, one a data rank: the
  tokens stay sharded over ``data`` through the expert block;
* reduced deepseek-v2: MLA's heads sharded (decode's against the whole
  latent cache), its dense first layer, shared experts beside the routed.

The train step's loss and gradient norm, every gradient (gathered), and
prefill's and decode's logits are held within rtol 1e-5, atol 1e-6. The
updated parameters (gathered) are held to one process's AdamW step on the
sharded run's own gradients within the same bounds: the ZeRO-1 update on
its shards and their gather. (Held to one process's whole step instead, a
handful of entries in ~10^5 miss by ~5e-6: AdamW's first step moves each
weight by ``lr * g / (|g| + eps)``, which turns the last-bit difference of
a gradient near 1e-8, summed in another order across the ranks, into a
visible one.)
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.configs import ARCHS as R_ARCHS
from repro_torch.configs import ARCHS

from _torch_mesh_step_worker import named, one_process, run_world

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6

# name -> (arch, config overrides)
CASES = {
    "minicpm_seq_sharded": ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3}),
    "minicpm_padded_heads": ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3, "pad_heads_to": 4}),
    "granite_experts": ("granite-moe-3b-a800m", {}),
    "granite_one_kv_head": ("granite-moe-3b-a800m", {"n_kv_heads": 1}),
    "granite_grouped_dispatch": ("granite-moe-3b-a800m", {"moe": 2}),
    "deepseek_mla": ("deepseek-v2-236b", {}),
}


def _config(base, over):
    """``base`` reduced, in float32, with ``over``'s fields; ``"moe": g``
    routes within ``g`` dispatch groups."""
    cfg = base.reduced()
    if "moe" in over:
        over = {**over, "moe": dataclasses.replace(cfg.moe, dispatch_groups=over["moe"])}
    return dataclasses.replace(cfg, dtype="float32", **over)


def _case(name):
    arch, over = CASES[name]
    cfg, rcfg = _config(ARCHS[arch], over), _config(R_ARCHS[arch], over)
    weights = jax.tree.map(np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(5), tp_size=2))
    rng = np.random.RandomState(7)

    def tok(*shape):
        return torch.from_numpy(rng.randint(0, cfg.vocab, shape).astype(np.int32))
    return {"cfg": cfg, "weights": weights, "inputs": tok(4, 16), "labels": tok(4, 16),
            "prompt": tok(2, 10), "token": tok(2, 1), "max_len": 14}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case: the gloo world's (one launch of 4 ranks)
    and this process's."""
    cases = {name: _case(name) for name in CASES}
    sharded = run_world(cases, tmp_path_factory.mktemp("mesh_step"), WORLD)
    return {name: (sharded[name], one_process(case, sharded[name]))
            for name, case in cases.items()}



def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_policy_takes_the_layout_the_case_names(runs, name):
    pol = runs[name][0]["policy"]
    assert (pol.tp_size, pol.dp_size) == (2, 2)
    want = {"minicpm_seq_sharded": (False, False, True),
            "minicpm_padded_heads": (True, True, False),
            "granite_experts": (True, True, False),
            "granite_one_kv_head": (True, False, False),
            "granite_grouped_dispatch": (True, True, False),
            "deepseek_mla": (True, True, False)}[name]
    assert (pol.shard_heads, pol.shard_kv_heads, pol.seq_shard_attn) == want
    assert pol.shard_experts == name.startswith(("granite", "deepseek"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_step_matches_one_process(runs, name):
    sharded, plain = runs[name]
    _close(sharded["loss"], plain["loss"].detach(), "loss")
    _close(sharded["gnorm"], plain["gnorm"].detach(), "gnorm")
    for what in ("grads", "params"):
        got = named(sharded[what])
        assert sorted(got) == sorted(plain[what])
        for leaf, want in plain[what].items():
            _close(got[leaf], want, f"{what} {leaf}")


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_serving_logits_match_one_process(runs, name, step):
    sharded, plain = runs[name]
    assert sharded[step].shape == plain[step].shape
    _close(sharded[step], plain[step], f"{step} logits")
