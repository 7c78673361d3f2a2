"""One rank of ``tests/test_torch_mesh_step.py``'s gloo world: a 2 x 2
``("data", "model")`` mesh on the CPU over a ``FileStore``.

    python tests/_torch_mesh_step_worker.py RANK WORLD STORE_FILE IN_FILE OUT_FILE

``IN_FILE`` (``torch.save``) holds the cases: each a config, the weights
(the reference's, as numpy), the train batch, the prompt and the decode
token. Every rank lays the weights, the AdamW state, the inputs and the
cache out by the port's specs (``parallel``, ``optim.opt_specs``) as
DTensors and runs ``StepBundle``'s train (its gradients recorded),
prefill and decode steps under the arch's policy; rank 0 writes the
gathered results to ``OUT_FILE``.
"""

import contextlib
import sys

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

        prompt, token = case["prompt"], case["token"]
        spol = policy_for(cfg, mesh, batch=prompt.shape[0])
    with mesh_context(spol):
        params = model()
        cache = init_cache(cfg, prompt.shape[0], case["max_len"], device="cpu")
        cache = _distribute(cache, cache_specs(cfg, spol), mesh)
        p_spec = batch_specs(cfg, spol, "prefill")
        logits, cache = bundle.prefill_step(params, _distribute(prompt, p_spec, mesh), cache)
        out["prefill"] = _full(logits)
        logits, cache = bundle.decode_step(params, _distribute(token, p_spec, mesh), cache,
                                           prompt.shape[1])
        out["decode"] = _full(logits)
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
