"""Set a finished PyTorch paper run against the banked JAX posterior.

    python3 scripts/torch_vs_banked.py --run results/torch_paper_nuts_hetx \
        --banked results/paper_nuts_hetx

Per parameter (in u), prints and writes to ``<run>/vs_banked_is.json``: the
run's mean shift from the banked mean in banked posterior sd, its z over the
Monte-Carlo error (read from the run's artifact), and, where the banked
directory holds ``logp64_draws.npy`` (the float64 log-density at the banked
draws), the shift that importance-reweighting the banked draws to that
density gives.  Two independent corrections of the banked posterior that
agree in sign and size say that the banked draws, not this run, are off.
Also sums the run's per-transition seconds over warmup and sampling.
Numpy only; needs no device.
"""

import argparse
import json
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="results/torch_paper_nuts_hetx")
    ap.add_argument("--banked", default="results/paper_nuts_hetx")
    args = ap.parse_args()
    with open(os.path.join(args.run, "paper_nuts_auditory.json")) as f:
        art = json.load(f)
    with open(os.path.join(args.run, "chunk_timing.json")) as f:
        timing = {int(k): v for k, v in json.load(f).items()}
    with np.load(os.path.join(args.run, "posterior_samples.npz")) as d:
        mine = d["raw_u"].reshape(-1, d["raw_u"].shape[-1])
    with np.load(os.path.join(args.banked, "posterior_samples.npz")) as d:
        banked = d["raw_u"].reshape(-1, d["raw_u"].shape[-1])
        logp = d["logp"].reshape(-1)
    names = list(art["vs_banked"])
    sd = banked.std(axis=0)
    out = {
        "shift_in_banked_sd": dict(zip(names, ((mine.mean(0) - banked.mean(0)) / sd).tolist())),
        "z": {k: v["z"] for k, v in art["vs_banked"].items()},
        "sd_ratio": dict(zip(names, (mine.std(axis=0) / sd).tolist())),
        "warmup_seconds": sum(v for k, v in timing.items() if k < art["config"]["warmup"]),
        "sampling_seconds": sum(v for k, v in timing.items() if k >= art["config"]["warmup"]),
    }
    out["n_abs_z_above_3"] = sum(abs(z) > 3 for z in out["z"].values())
    path64 = os.path.join(args.banked, "logp64_draws.npy")
    if os.path.exists(path64):
        # self-normalized importance weights from the sampler's density to
        # the float64 one, at the banked draws
        lw = np.load(path64) - logp
        w = np.exp(lw - lw.max())
        w /= w.sum()
        is_shift = ((w[:, None] * banked).sum(axis=0) - banked.mean(axis=0)) / sd
        out["banked_is_shift_in_banked_sd"] = dict(zip(names, is_shift.tolist()))
        out["is_ess_fraction"] = float(1.0 / np.sum(w ** 2) / w.size)
        out["correlation_of_the_two_shifts"] = float(np.corrcoef(
            is_shift, list(out["shift_in_banked_sd"].values()))[0, 1])
    with open(os.path.join(args.run, "vs_banked_is.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
