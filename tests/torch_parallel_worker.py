"""The rank side of ``test_torch_parallel.py``: spawned processes that run
the port's sharded drivers over gloo on the CPU.  It imports no JAX: the
JAX package runs only in the pytest process, and the ranks send numpy
results back through a queue."""

import multiprocessing as mp
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist

import gpcsd_tpu_torch as gt
from gpcsd_tpu_torch import convert
from gpcsd_tpu_torch.models.core import value_and_grad_rows
from gpcsd_tpu_torch.parallel import mesh as M
from gpcsd_tpu_torch.parallel import sharded as S

#: the runs each rank makes, shared with the test's unsharded twins
NUTS = dict(seed=1, n_chains=4, num_warmup=10, num_samples=10, max_depth=5)
POSTERIOR = dict(seed=2, n_chains=2, num_warmup=6, num_samples=6, max_depth=4)
MAP = dict(seed=3, n_restarts=3, maxiter=15)
#: constrained values pinned in the restarts of one more sharded MAP
PINNED = {"R": 150.0}
SMC = dict(seed=4, n_particles=31, n_mutation_steps=2, chunk=5)
ADVI = dict(seed=5, num_steps=20, n_mc=4)
REFUSED = {"pool_warmup": True, "state_path": "unused", "callback": print, "laplace": True,
           "reparam": "amplitude"}


def model_from_spec(spec):
    """The port's model (CPU) from the numpy spec the test draws."""
    sd = spec["prior_sd"]
    prior = [gt.HalfNormal(s) for s in sd] if np.ndim(sd) else gt.HalfNormal(sd)
    return convert.model_from_reference_params(
        spec["lfp"], spec["x"], spec["t"], spec["theta"], a=spec["a"], b=spec["b"],
        ngl=spec["ngl"], sig2n_prior=prior, het_noise=spec["het_noise"], device="cpu",
    )


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "_fields"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    return tree


def _refuses(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def _rank_cases(specs, us):
    """Every case of the test file on this rank; a dict of numpy results."""
    cpu = dict(device_type="cpu")
    out = {"rank": dist.get_rank()}
    out["mesh_default"] = tuple(M.make_mesh(**cpu).shape)
    out["mesh_trial2"] = tuple(M.make_mesh(trial=2, **cpu).shape)
    out["mesh_refused"] = [_refuses(lambda kw=kw: M.make_mesh(**kw, **cpu))
                           for kw in ({"chain": 3, "trial": 2}, {"chain": 5}, {"trial": 8})]
    mesh22 = M.make_mesh(chain=2, trial=2, **cpu)
    mesh14 = M.make_mesh(chain=1, trial=4, **cpu)
    mesh21 = M.make_mesh(chain=2, trial=1, **cpu)  # ranks 2 and 3 take no part
    out["coord21"] = mesh21.get_coordinate()

    models = {name: model_from_spec(spec) for name, spec in specs.items()}
    for label, name, mesh in (("plain22", "plain", mesh22), ("plain14", "plain", mesh14),
                              ("hetx14", "hetx", mesh14)):
        fns, Y = models[name]._fns(), models[name]._Y()
        lp = S.make_trial_sharded_log_prob(fns, Y.shape[0], mesh)
        Yb = M.shard_trials(mesh, Y)
        v, g = value_and_grad_rows(lambda u: lp(u, Yb), torch.as_tensor(us[name]))
        out[label] = (v.numpy(), g.numpy(), tuple(Yb.shape))

    m = models["plain"]
    fns, Y = m._fns(), m._Y()
    out["map21"] = S.map_fit_sharded(fns, Y, mesh21, **MAP)
    out["map22"] = S.map_fit_sharded(fns, Y, mesh22, **MAP)
    out["map21_pinned"] = S.map_fit_sharded(fns, Y, mesh21, **MAP, init_overrides=PINNED)
    out["nuts"] = _np(S.nuts_sharded(fns, Y, mesh21, **NUTS))
    out["smc"] = _np(S.smc_sharded(fns, Y, mesh22, **SMC))
    out["advi"] = _np(S.advi_sharded(fns, Y, mesh14, **ADVI))
    for label, mesh in (("posterior21", mesh21), ("posterior22", mesh22)):
        post = m.sample_posterior(mesh=mesh, **POSTERIOR)
        out[label] = None if post is None else _np(post.raw)
    out["refused"] = {k: _refuses(lambda k=k, v=v: m.sample_posterior(mesh=mesh22, **{k: v}))
                      for k, v in REFUSED.items()}
    outside = gt.GPCSD1D(np.asarray(specs["plain"]["lfp"]), specs["plain"]["x"],
                         specs["plain"]["t"], ngl=10, device="cpu")
    out["outside"] = [
        outside.sample_posterior(mesh=mesh21, n_chains=2, num_warmup=2, num_samples=2,
                                 max_depth=2) is None,
        outside.advi(mesh=mesh21, num_steps=2, n_mc=2, n_draws=3) is None,
        outside.smc(mesh=mesh21, n_particles=8, n_mutation_steps=1) is None,
        getattr(outside, "posterior", None) is None,
    ]
    return out


def _rank_main(rank, world, init_file, specs, us, results):
    try:
        torch.set_num_threads(1)
        M.init_distributed(f"file://{init_file}", world, rank, backend="gloo")
        results.put(_rank_cases(specs, us))
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world, init_file, specs, us, timeout=300.0):
    """Run :func:`_rank_cases` on ``world`` spawned gloo ranks; their dicts
    in rank order.  Raises with a rank's traceback when one fails."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, init_file, specs, us, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out = []
    try:
        while len(out) < world:  # drain before joining; stop at the first failure
            out.append(results.get(timeout=timeout))
            if "error" in out[-1]:
                raise RuntimeError(f"rank {out[-1]['rank']} failed:\n{out[-1]['error']}")
    except queue.Empty:
        raise TimeoutError(f"{world - len(out)} of {world} ranks did not report "
                           f"within {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=0 if len(out) < world else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    return sorted(out, key=lambda o: o["rank"])
