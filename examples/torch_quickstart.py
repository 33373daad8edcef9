"""Quickstart on PyTorch: co-cluster a planted matrix with LAMC, persist the
fitted model, and assign new rows against the restored artifact.

    PYTHONPATH=src python examples/torch_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --rows 350 --cols 225

Walks the production loop of ``examples/quickstart.py`` with the
``repro_torch`` package: batch fit -> score -> the unpartitioned SCC
baseline -> save the CoclusterModel checkpoint -> load it back ->
out-of-sample ``assign_rows`` — then prints the phase-span trace of what just
ran. The planted matrix has ``--rows`` rows (the last seventh held out for
serving) and ``--cols`` columns; the smallest co-cluster of interest is a
fifth of each. ``main`` returns the scores it prints.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile

import numpy as np
import torch

from repro_torch import obs, streaming
from repro_torch.core import LAMCConfig, cocluster_scores, lamc_cocluster
from repro_torch.core.baselines import scc_full
from repro_torch.core.metrics import nmi
from repro_torch.data import planted_cocluster_matrix
from repro_torch.device import resolve_device


def _phase_timer(dev: torch.device):
    """``lamc_cocluster``'s ``timer``: one obs span per phase, closed after
    the device has finished the phase's work."""
    @contextlib.contextmanager
    def timer(name: str):
        with obs.span(name):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    return timer


def run(n_rows: int = 1400, n_cols: int = 900, device: str = "cuda") -> dict:
    dev = resolve_device(device)
    obs.reset_trace()
    rng = np.random.default_rng(0)
    fit_rows = n_rows - n_rows // 7
    data = planted_cocluster_matrix(rng, n_rows, n_cols, k=5, d=5,
                                    signal=4.0, noise=0.7)
    a = torch.from_numpy(data.matrix[:fit_rows]).to(dev)
    heldout = torch.from_numpy(data.matrix[fit_rows:]).to(dev)

    # the probabilistic model picks (m, n, T_p) for a 95% detection floor
    cfg = LAMCConfig(
        n_row_clusters=5, n_col_clusters=5,
        min_cocluster_rows=fit_rows // 5,   # the smallest co-cluster we care about
        min_cocluster_cols=n_cols // 5,
        p_thresh=0.95,
        workers=4,                          # pretend 4 parallel units; plan adapts
    )
    with obs.span("lamc", rows=fit_rows, cols=n_cols, device=str(dev)):
        out = lamc_cocluster(a, cfg, device=dev, timer=_phase_timer(dev))
    plan = out.plan
    print(f"plan: {plan.m}x{plan.n} blocks of {plan.phi}x{plan.psi}, "
          f"T_p={plan.t_p} resamples, detection>= {plan.detection_p:.3f}")

    s = cocluster_scores(out.row_labels.cpu().numpy(), out.col_labels.cpu().numpy(),
                         data.row_labels[:fit_rows], data.col_labels)
    print(f"LAMC     : NMI={s['nmi']:.3f} ARI={s['ari']:.3f}")

    with obs.span("scc_full") as sp:
        base = sp.fence(scc_full(a, 5, device=dev))
    sb = cocluster_scores(base.row_labels.cpu().numpy(), base.col_labels.cpu().numpy(),
                          data.row_labels[:fit_rows], data.col_labels)
    print(f"full SCC : NMI={sb['nmi']:.3f} ARI={sb['ari']:.3f}")

    # fit -> save -> load -> assign: the serving loop (DESIGN.md §10)
    with tempfile.TemporaryDirectory() as ckpt_dir, obs.span("serve_loop"):
        model = streaming.model_from_result(out)
        streaming.save_model(ckpt_dir, model, cfg=cfg, plan=plan)
        restored, meta = streaming.load_model(ckpt_dir, device=dev)
        print(f"saved + restored model ({meta['kind']}, "
              f"{restored.n_rows}x{restored.n_cols})")
        res = streaming.assign_rows(restored, heldout)
        agree = nmi(res.labels.cpu().numpy(), data.row_labels[fit_rows:])
        mean_score = float(res.score.mean())
        print(f"held-out assign_rows: NMI vs planted truth = {agree:.3f}, "
              f"mean score {mean_score:.3f}")

    # where the time went: the span tree of everything above
    print("\nfit trace:")
    print(obs.render_trace())
    return dict(plan=(plan.m, plan.n, plan.phi, plan.psi, plan.t_p),
                lamc_nmi=s["nmi"], lamc_ari=s["ari"],
                scc_full_nmi=sb["nmi"], scc_full_ari=sb["ari"],
                heldout_nmi=agree, heldout_mean_score=mean_score)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=1400,
                    help="planted rows, the last seventh held out for serving")
    ap.add_argument("--cols", type=int, default=900)
    args = ap.parse_args(argv)
    was = obs.enabled()
    obs.configure(enabled=True)  # span-trace the whole loop
    try:
        return run(args.rows, args.cols, args.device)
    finally:
        obs.configure(enabled=was)


if __name__ == "__main__":
    main()
