"""One rank of ``tests/test_torch_mesh_step.py``'s gloo world: a 2 x 2
``("data", "model")`` mesh on the CPU over a ``FileStore``.

    python tests/_torch_mesh_step_worker.py RANK WORLD STORE_FILE IN_FILE OUT_FILE

``IN_FILE`` (``torch.save``) holds the cases: each a config, the weights
(the reference's, as numpy), the train batch, the prompt and the decode
token, or ``tokens``, one a decode step. Every rank lays the weights, the AdamW state, the inputs and the
cache out by the port's specs (``parallel``, ``optim.opt_specs``) as
DTensors and runs ``StepBundle``'s train (its gradients recorded),
prefill and decode steps under the arch's policy; rank 0 writes the
gathered results to ``OUT_FILE``.
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist


def _distribute(tree, specs, mesh):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel import placements
    from repro_torch.tree import tree_map

    return tree_map(lambda t, s: distribute_tensor(t, mesh, list(placements(s, mesh))),
                    tree, specs)


@contextlib.contextmanager
def recording_grads():
    """Within it, ``StepBundle.train_step`` also leaves the gradients it
    computes in the yielded list."""
    from repro_torch.launch import steps

    seen, real = [], steps.loss_and_grads

    def record(*args, **kwargs):
        loss, grads = real(*args, **kwargs)
        seen.append(grads)
        return loss, grads
    steps.loss_and_grads = record
    try:
        yield seen
    finally:
        steps.loss_and_grads = real


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def run_case(case, mesh):
    from repro_torch.launch.steps import StepBundle
    from repro_torch.models import LanguageModel, init_cache
    from repro_torch.models.convert import tree_from_numpy
    from repro_torch.optim import adamw_init
    from repro_torch.models.meshed import mesh_context
    from repro_torch.parallel import batch_specs, cache_specs, policy_for
    from repro_torch.tree import tree_map

    cfg = case["cfg"]
    bundle = StepBundle(cfg, mesh)
    out = {"policy": bundle.policy}

    def model():
        tree = tree_from_numpy(case["weights"], cfg, device="cpu")
        return LanguageModel(cfg, _distribute(tree, bundle.pspecs, mesh))

    inputs, labels = case["inputs"], case["labels"]
    pol = policy_for(cfg, mesh, batch=inputs.shape[0])
    with mesh_context(pol):
        params = model()
        params.requires_grad_(True)
        opt = adamw_init(tree_from_numpy(case["weights"], cfg, device="cpu"))
        opt = {"step": opt["step"],
               **{k: _distribute(opt[k], bundle.ospecs[k], mesh) for k in ("master", "m", "v")}}
        in_spec, lab_spec = batch_specs(cfg, pol, "train")
        x, y = _distribute(inputs, in_spec, mesh), _distribute(labels, lab_spec, mesh)
        with recording_grads() as grads:
            params, opt, metrics = bundle.train_step(params, opt, x, y)
        out["grads"] = tree_map(lambda g: _full(g).detach(), grads[0])
        out["loss"] = _full(metrics["loss"]).detach()
        out["gnorm"] = _full(metrics["gnorm"]).detach()
        out["params"] = tree_map(lambda p: _full(p).detach(), params.param_tree())

        prompt = case["prompt"]
        spol = policy_for(cfg, mesh, batch=prompt.shape[0])
    with mesh_context(spol):
        params = model()
        cache = init_cache(cfg, prompt.shape[0], case["max_len"], device="cpu")
        cache = _distribute(cache, cache_specs(cfg, spol), mesh)
        p_spec = batch_specs(cfg, spol, "prefill")
        logits, cache = bundle.prefill_step(params, _distribute(prompt, p_spec, mesh), cache)
        out["prefill"] = _full(logits)
        steps = []
        for i, token in enumerate(decode_tokens(case)):
            logits, cache = bundle.decode_step(params, _distribute(token, p_spec, mesh), cache,
                                               prompt.shape[1] + i)
            steps.append(_full(logits))
        out["decode"] = torch.cat(steps, dim=1)
    return out


def decode_tokens(case):
    """The case's decode inputs, one a step (``tokens``, else the one
    ``token``), at positions from the prompt's length on."""
    return case.get("tokens") or [case["token"]]


def run_world(cases, tmp: Path, world: int = 4, timeout: float = 150) -> dict:
    """One launch of ``world`` ranks of this script over ``cases`` (saved
    under ``tmp``); returns rank 0's results."""
    root = Path(__file__).resolve().parents[1]
    torch.save(cases, tmp / "in.pt")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep),
        "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(world),
                               str(tmp / "store"), str(tmp / "in.pt"), str(tmp / "out.pt")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(world)]
    logs = [p.communicate(timeout=timeout)[0].decode(errors="replace") for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return torch.load(tmp / "out.pt", weights_only=False)


def named(tree):
    from repro_torch.tree import tree_leaves_with_names

    return {k: v.detach() for k, v in tree_leaves_with_names(tree)}


def one_process(case, sharded):
    """The case's steps on plain tensors in this process: the train step's
    loss, gradient norm and gradients, one process's AdamW on the sharded
    run's gathered gradients, and the prefill's and decode steps' logits."""
    from repro_torch.launch.steps import StepBundle
    from repro_torch.models import init_cache, params_from_numpy
    from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

    cfg = case["cfg"]
    bundle = StepBundle(cfg)
    params = params_from_numpy(case["weights"], cfg, device="cpu")
    params.requires_grad_(True)
    opt = adamw_init(params.param_tree())
    with recording_grads() as grads:
        params, opt, metrics = bundle.train_step(params, opt, case["inputs"], case["labels"])
    out = {"loss": metrics["loss"], "gnorm": metrics["gnorm"], "grads": named(grads[0])}
    # AdamW on one process, from the sharded run's gathered gradients
    params = params_from_numpy(case["weights"], cfg, device="cpu")
    clipped, _ = clip_by_global_norm(sharded["grads"], bundle.clip)
    adamw_update(params.param_tree(), clipped, adamw_init(params.param_tree()), bundle.lr)
    out["params"] = named(params.param_tree())
    params = params_from_numpy(case["weights"], cfg, device="cpu")
    cache = init_cache(cfg, case["prompt"].shape[0], case["max_len"], device="cpu")
    out["prefill"], cache = bundle.prefill_step(params, case["prompt"], cache)
    steps = []
    for i, token in enumerate(decode_tokens(case)):
        logits, cache = bundle.decode_step(params, token, cache, case["prompt"].shape[1] + i)
        steps.append(logits)
    out["decode"] = torch.cat(steps, dim=1)
    return out


def main(rank: int, world: int, store_file: str, in_file: str, out_file: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    store = dist.FileStore(store_file, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, world // 2), mesh_dim_names=("data", "model"))
        cases = torch.load(in_file, weights_only=False)
        results = {name: run_case(case, mesh) for name, case in cases.items()}
        if rank == 0:
            torch.save(results, out_file)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
