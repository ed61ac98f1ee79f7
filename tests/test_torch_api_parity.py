"""API parity of the PyTorch port with the JAX package, read from the two
source trees with ``ast`` (neither package is imported).

Every public function and class of ``gpcsd_tpu/`` (module level, and the
public methods of public classes), and every argument of each one that has
a counterpart, must exist in ``gpcsd_tpu_torch/`` under the same module and
name, or stand in one of the allowlists below with a one-line reason.  An
allowlisted name or argument that gains a counterpart fails the test too,
so the lists cannot go stale.  The lists hold only TPU workarounds (the
precision policy, the iterative eigensolvers, the warm-started eigenbasis,
the chunked drivers that bound a TPU dispatch, the Pallas kernel's switches),
renamed random-key arguments (``key`` -> a generator, a seed or pre-drawn
numbers), renamed mesh arguments (``jax.sharding`` -> ``torch.distributed``)
and the JAX package's orbax checkpoint route.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: JAX module -> the port's module of the same job under another path
MODULES = {"ops.pallas.quadform": "ops.cuda.quadform"}
#: port functions taking ``**kwargs`` that they hand on to another port function
FORWARDS = {"infer.nuts:nuts_run": "infer.nuts:nuts_chains"}

_POLICY = "the f32/mixed precision policy of the TPU; the port computes in float64"
_WARM = "threads the warm-started eigenbasis along trajectories, a TPU eigensolver workaround"
_SPEC = "a jax.sharding PartitionSpec for shard_map; the port's mesh is a DeviceMesh"

#: JAX names with no counterpart in the port
NOT_PORTED = {
    "config:Policy": _POLICY,
    "config:Policy.resolve_compute_dtype": _POLICY,
    "config:Policy.resolve_factor_dtype": _POLICY,
    "config:get_policy": _POLICY,
    "config:set_policy": _POLICY,
    "infer.hmc:as_aux_vga": _WARM,
    "infer.hmc:vma0": "seeds shard_map's varying-across-mesh types; no such typing on a torch mesh",
    "infer.lbfgs:lbfgs_minimize_chunked":
        "bounds each TPU dispatch; its state_path, max_wall_seconds, chunk_iters are lbfgs_minimize's",
    "infer.nuts:nuts_chains_chunked":
        "bounds each TPU dispatch; nuts_chains(state_path=, save_every=) checkpoints and resumes",
    "models.reparam:AmplitudeReparam.wrap_log_prob_aux": _WARM,
    "ops.jacobi:eigh_jacobi":
        "the TPU's Jacobi eigensolver; the port's is ops.cuda.eigh.eigh_jacobi_cuda, a block Jacobi kernel",
    "ops.kronlik:comp_eig_d_preconditioned": "temporal eigh in a fixed reference basis, for the TPU's Jacobi solver",
    "ops.kronlik:dct_basis": "the Jacobi solver's start basis; the port's is ops.cuda.eigh.dct_basis, beside it",
    "ops.kronlik:eigh_mixed": "double-f32 eigensolver for the TPU",
    "ops.kronlik:orth_polish": _WARM,
    "parallel.mesh:chain_spec": _SPEC,
    "parallel.mesh:replicated": _SPEC,
    "parallel.mesh:trial_spec": _SPEC,
    "parallel.sharded:make_trial_sharded_log_prob_aux": _WARM,
    "utils.profiling:xla_trace": "an XLA trace; its counterpart is utils.profiling.trace (torch.profiler)",
}

_GEN = "random key -> a generator"
_SEED = "random key -> a seed"
_DRAWN = "random key -> the numbers drawn with it"

#: arguments of JAX names that the port's counterpart does not take
ARGS = {
    "infer.advi:ADVIResult.sample": {"key": _GEN},
    "infer.advi:advi_fit": {"key": _GEN},
    "infer.advi:elbo": {"key": _DRAWN, "n_mc": "random key -> eps, whose rows are the n_mc draws"},
    "infer.dense_metric:draw_momentum": {"key": _DRAWN},
    "infer.hmc:draw_momentum": {"key": _DRAWN, "shape": "random key -> xi, which has the shape",
                                "dtype": "random key -> xi, which has the dtype"},
    "infer.hmc:find_reasonable_step_size": {"key": _DRAWN, "aux": _WARM,
                                            "vga": "value-and-grad with the aux slot -> vg without it"},
    "infer.hmc:leapfrog": {"aux": _WARM, "vga": "value-and-grad with the aux slot -> vg without it"},
    "infer.map:map_fit": {"key": "random key -> u0s, drawn by sample_restarts(gen, n, fixed=)",
                          "n_restarts": "random key -> u0s, whose rows are the restarts",
                          "init_overrides": "random key -> u0s, drawn by sample_restarts(fixed=)"},
    "infer.map:sample_restarts": {"key": _GEN},
    "infer.nuts:nuts_chains": {"key": "random key -> gens, one generator a chain",
                               "num_chains": "random key -> gens, one generator a chain"},
    "infer.nuts:nuts_run": {"key": _GEN, "log_prob_aux": _WARM, "aux0": _WARM},
    "infer.nuts:nuts_transition": {"key": _DRAWN, "aux": _WARM,
                                   "value_and_grad": "value-and-grad with the aux slot -> vg without it"},
    "infer.nuts:stepsize_floor_guard": {
        "chunk": "index of a TPU dispatch chunk -> at, the transition's index"},
    "infer.smc:smc_run": {"key": _GEN,
                          "batch_prior": "shard_map hook; the port's density functions are batched",
                          "batch_like": "shard_map hook; smc_sharded passes its own log_like_fn"},
    "infer.smc:systematic_resample": {"key": _DRAWN},
    "io.checkpoint:save_sampler_state": {"backend": "chooses JAX's orbax route; the port writes npz only"},
    "io.checkpoint:load_sampler_state": {"like": "orbax's restore template; the port takes device="},
    "models.core:make_model_fns": {"precondition": "preconditioned coordinates for the TPU's Jacobi solver"},
    "models.inference_api:InferenceAPIMixin.sample_posterior": {
        "chunk_size": "transitions per TPU dispatch", "precondition": _WARM, "warm_basis": _WARM},
    "models.params:ParamSet.sample": {"key": _GEN},
    "models.priors:Prior.sample": {"key": _GEN},
    "models.priors:HalfNormal.sample": {"key": _GEN},
    "models.priors:InvGamma.sample": {"key": _GEN},
    "models.priors:Normal.sample": {"key": _GEN},
    "models.torus_graph:bootstrap_partial_plv": {"key": "random key -> generator= or indices="},
    "ops.pallas.quadform:quadform": {
        "interpret": "Pallas's interpreter for the TPU kernel; the port's CPU tensors take the plain version",
        "use_pallas": "the TPU kernel or the plain version; the port chooses by the tensors' device"},
    "ops.rff:se_rff_features": {"key": _DRAWN,
                                "n_features": "random key -> w_unit and b, whose rows are the features"},
    "parallel.mesh:make_mesh": {"devices": "jax devices -> ranks= and device_type= of torch.distributed"},
    "parallel.sharded:make_trial_sharded_log_prob": {"axis_name": "shard_map axis name -> the mesh"},
    "parallel.sharded:nuts_sharded": {"key": _SEED, "warm_basis": _WARM},
    "parallel.sharded:advi_sharded": {"key": _SEED},
    "parallel.sharded:smc_sharded": {"key": _SEED},
    "parallel.sharded:map_fit_sharded": {"key": _SEED},
}


def _args(fn):
    a = fn.args
    names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs} - {"self", "cls"}
    return names, a.kwarg is not None


def inventory(package):
    """``{"module:name" or "module:Class.method": (argument names, takes
    **kwargs)}`` of the public definitions under ``package``; a class maps to
    its ``__init__``'s arguments."""
    out = {}
    root = os.path.join(ROOT, package)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_", "."))]
        for fname in filenames:
            if not fname.endswith(".py") or (fname.startswith("_") and fname != "__init__.py"):
                continue
            path = os.path.join(dirpath, fname)
            module = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            module = module.removesuffix(".__init__")
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in tree.body:
                if getattr(node, "name", "_").startswith("_"):
                    continue
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{module}:{node.name}"] = _args(node)
                elif isinstance(node, ast.ClassDef):
                    out[f"{module}:{node.name}"] = (set(), False)
                    for sub in node.body:
                        if not isinstance(sub, ast.FunctionDef):
                            continue
                        if sub.name == "__init__":
                            out[f"{module}:{node.name}"] = _args(sub)
                        elif not sub.name.startswith("_"):
                            out[f"{module}:{node.name}.{sub.name}"] = _args(sub)
    return out


JAX = inventory("gpcsd_tpu")
PORT = inventory("gpcsd_tpu_torch")


def counterpart(name):
    module, rest = name.split(":")
    return f"{MODULES.get(module, module)}:{rest}"


def port_args(name):
    names, var_kw = PORT[name]
    if var_kw and name in FORWARDS:
        names = names | PORT[FORWARDS[name]][0]
    return names


SUBPACKAGES = sorted({name.split(":")[0].split(".")[0] for name in JAX})


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_every_jax_name_and_argument_has_a_counterpart_or_a_reason(subpackage):
    missing, stale = [], []
    for name in sorted(n for n in JAX if n.split(":")[0].split(".")[0] == subpackage):
        theirs = counterpart(name)
        if name in NOT_PORTED:
            if theirs in PORT:
                stale.append(f"{name} is ported now: take it off NOT_PORTED")
            continue
        if theirs not in PORT:
            missing.append(f"{name} has no counterpart {theirs}")
            continue
        lacking = JAX[name][0] - port_args(theirs)
        allowed = set(ARGS.get(name, {}))
        missing += [f"{name}({arg}=) has no counterpart" for arg in sorted(lacking - allowed)]
        stale += [f"{name}({arg}=) is ported now: take it off ARGS" for arg in sorted(allowed - lacking)]
    assert not missing and not stale, "\n".join(missing + stale)


def test_allowlists_name_jax_definitions_and_give_reasons():
    for name, reason in NOT_PORTED.items():
        assert name in JAX, f"{name} is not in the JAX package"
        assert isinstance(reason, str) and reason.strip(), name
    for name, args in ARGS.items():
        assert name in JAX and name not in NOT_PORTED, name
        for arg, reason in args.items():
            assert arg in JAX[name][0], f"{name} takes no {arg}"
            assert isinstance(reason, str) and reason.strip() and "\n" not in reason, (name, arg)
    for name, target in FORWARDS.items():
        assert PORT[name][1] and target in PORT, name


def test_inventory_reads_both_trees():
    """The walk finds what it must: the model classes' methods, a renamed
    module, the names of this slice."""
    assert {"models.gpcsd1d:GPCSD1D.fit", "models.gpcsd2d:GPCSD2D.fit", "ops.pallas.quadform:quadform",
            "infer.lbfgs:LBFGSTimeBudget", "utils.profiling:Throughput.rate"} <= set(JAX)
    assert "profile" in PORT["models.gpcsd2d:GPCSD2D.fit"][0]
    assert {"state_path", "max_wall_seconds", "chunk_iters"} <= PORT["infer.lbfgs:lbfgs_minimize"][0]
    assert "ops.cuda.quadform:quadform" in PORT and "utils.profiling:trace" in PORT
    assert len(JAX) > 200 and len(PORT) > 300
