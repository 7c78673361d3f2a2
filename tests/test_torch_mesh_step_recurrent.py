"""The sharded step on a mesh against one process, on the CPU: the layouts
the recurrent, windowed and frontend archs add.

The same 4-process ``gloo`` world as ``tests/test_torch_mesh_step.py``
(``tests/_torch_mesh_step_worker.py``, a 2 x 2 ``("data", "model")``
mesh), launched once for this file, runs ``StepBundle``'s train, prefill
and several decode steps over DTensors placed by the port's specs; this
process runs the same steps on plain tensors. In float32, on the
reference's weights carried across, for:

* reduced recurrentgemma at 3 heads over 1 kv head: the RG-LRU scan
  channel-sharded (its op's sharding rule, and its backward's), the local
  attention sequence-sharded, its ring-buffer window cache rows-sharded;
* reduced falcon-mamba, trained on 70 tokens (two of the scan's 64-step
  chunks, so its saved chunk state is sharded too): the fused Mamba scan
  channel-sharded, its ``d b`` and ``d c`` partial sums over ``model``;
* reduced danube at one kv head: the ring rows-sharded, a prefill shorter
  than the window but longer than a rank's rows (the shift crosses
  ranks);
* reduced gemma2: the ring kv-head-sharded, both softcaps;
* reduced paligemma at 3 heads: its prefix mask under the sequence-sharded
  fallback, embeddings ``[B, S, F]`` in;
* reduced musicgen: embeddings ``[B, S, F]`` through ``frontend_proj``.

Every windowed case decodes past its window (at least two steps at
``pos >= rows``), so rows shift across the ranks and the shifted cache is
then read. The train step's loss and gradient norm, every gradient
(gathered), and prefill's and each decode step's logits are held within
rtol 1e-5, atol 1e-6; the updated parameters to one process's AdamW on the
sharded run's own gradients, as in ``test_torch_mesh_step.py``. The one
process side is what ``tests/test_torch_models.py`` holds to the
reference.

The serving batch is 4, two rows a data rank: at one row a rank the CPU's
BLAS takes its matrix-vector path, whose sum over a frontend's 512 or
1152 inputs runs in another order than the matrix product one process
runs over two rows (2.6e-6 apart at the first projection).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.configs import ARCHS as R_ARCHS
from repro_torch.configs import ARCHS
from repro_torch.models.transformer import FRONTEND_DIMS

from _torch_mesh_step_worker import named, one_process, run_world

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6

# name -> (arch, config overrides, train tokens, prompt length, decode steps)
CASES = {
    "recurrentgemma_channels_ring": ("recurrentgemma-2b", {"n_heads": 3, "window": 6}, 16, 10, 3),
    "falcon_mamba_channels": ("falcon-mamba-7b", {}, 70, 10, 2),
    "danube_rows_ring": ("h2o-danube-3-4b", {"n_kv_heads": 1, "window": 8}, 16, 6, 4),
    "gemma2_kv_heads_ring": ("gemma2-27b", {"window": 6}, 16, 10, 3),
    "paligemma_prefix_seq_sharded": ("paligemma-3b", {"n_heads": 3}, 16, 10, 2),
    "musicgen_frontend": ("musicgen-large", {}, 16, 10, 2),
}


def _config(base, over):
    return dataclasses.replace(base.reduced(), dtype="float32", **over)


def _case(name):
    arch, over, seq, prompt, steps = CASES[name]
    cfg, rcfg = _config(ARCHS[arch], over), _config(R_ARCHS[arch], over)
    weights = jax.tree.map(np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(5), tp_size=2))
    rng = np.random.RandomState(7)

    def tok(*shape):
        return torch.from_numpy(rng.randint(0, cfg.vocab, shape).astype(np.int32))

    def inputs(*shape):  # tokens, or a frontend's embeddings
        if not cfg.frontend:
            return tok(*shape)
        return torch.from_numpy(rng.randn(*shape, FRONTEND_DIMS[cfg.frontend])
                                .astype(np.float32))
    return {"cfg": cfg, "weights": weights, "inputs": inputs(4, seq), "labels": tok(4, seq),
            "prompt": inputs(4, prompt), "tokens": [inputs(4, 1) for _ in range(steps)],
            "max_len": prompt + steps}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case: the gloo world's (one launch of 4 ranks)
    and this process's."""
    cases = {name: _case(name) for name in CASES}
    sharded = run_world(cases, tmp_path_factory.mktemp("mesh_step_recurrent"), WORLD,
                        timeout=300)
    return {name: (sharded[name], one_process(case, sharded[name]))
            for name, case in cases.items()}


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"{what}: {m}")


def _ring_rows(name):
    """The windowed case's ring rows: ``min(window, max_len)``, or None."""
    arch, over, _, prompt, steps = CASES[name]
    window = over.get("window")
    return None if window is None else min(window, prompt + steps)


@pytest.mark.parametrize("name", sorted(CASES))
def test_policy_takes_the_layout_the_case_names(runs, name):
    from repro_torch.parallel import cache_specs

    sharded, _ = runs[name]
    pol = sharded["policy"]
    assert (pol.tp_size, pol.dp_size) == (2, 2)
    want = {"recurrentgemma_channels_ring": (False, False, True),
            "falcon_mamba_channels": (True, False, False),
            "danube_rows_ring": (True, False, False),
            "gemma2_kv_heads_ring": (True, True, False),
            "paligemma_prefix_seq_sharded": (False, False, True),
            "musicgen_frontend": (True, True, False)}[name]
    assert (pol.shard_heads, pol.shard_kv_heads, pol.seq_shard_attn) == want
    rows = _ring_rows(name)
    if rows is not None:  # decoded past the window: at least two steps at pos >= rows
        _, _, _, prompt, steps = CASES[name]
        assert sum(prompt + i >= rows for i in range(steps)) >= 2
    cfg = _config(ARCHS[CASES[name][0]], CASES[name][1])
    kinds = {"rglru": (pol.dp, "model"), "mamba": (pol.dp, "model", None),
             "attn_local": (pol.dp, None, "model", None) if not pol.shard_kv_heads
             else (pol.dp, "model", None, None)}
    specs = cache_specs(cfg, pol)["stages"][0]
    for kind, spec in zip(cfg.pattern_unit, specs):
        if kind in kinds:  # the channels, or the ring's rows or kv heads, over model
            assert spec[0] == kinds[kind], kind


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
    if step == "decode":
        assert sharded[step].shape[1] == CASES[name][4]
    _close(sharded[step], plain[step], f"{step} logits")
