"""Which stage of a loop iteration rounds a batch frame apart from the same
frame traced alone, on a CUDA card.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tests/torch_batch_invariance.py [--iters 3] [--demo-frames 16]
        [--big-frames 4] [--odd]

For example ``--iters 16 --odd --demo-frames 256 --big-frames 0`` and
``--iters 16 --odd --demo-frames 0 --big-frames 16`` hold
``chip_smoke.py``'s widest odd-E batches (about 1-2 min each on an H100).

For ``chip_smoke.py``'s demo batch (image seeds 1-16, or 1-N with
``--demo-frames N``; 0 leaves it out) and 1000² batch (image seeds 1-4,
or 1-N with ``--big-frames N``), tracer seed 1, with ``--odd`` the right
endpoint one column in (E = 499 and 999: the loop scores through K2 and
``line_and_arc``'s Simpson sums over E), it steps the batch's loop with
``trace_batch``'s default draws, and at each iteration feeds every stage
of ``trace/driver.py::_iteration`` the batch's own inputs to that stage,
once for all frames and once for each frame alone (a batch of one, as a
single trace runs it). It prints, per stage, how many frames' outputs
differ from their single run in any bit and by how much at most: a stage
whose output depends on the batch size moves a batch frame off its single
trace. The sampling round's solve (K6) and cross product (K8) are shown
beside one batched library call each ("... batched call"), and the port's
own sampling round (``_sample_round``) beside the curves of those library
calls ("batched samples"); the stages after it take the port's curves. The
masked std and the kept curves' weights are shown also as one
``torch.sum`` over every frame ("... one torch.sum call"), beside the
port's ``frame_sum`` (K9), and so are
the costs, whose sums over E the port takes by ``ops/sums.py::fixed_sum``.
After the last iteration the final fit runs on the state the loop reached
(its mean curve, std, θ and LML, batch against each frame alone), and the
final cost (``curve_costs`` at S = 1 on the batch's final mean curves),
also as one ``torch.sum`` call. The last line is one JSON object of all
rows; the script exits 1 if a stage of the port (a row that is not a
contrast) moved a frame.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

import numpy as np

sys.path.append(str(pathlib.Path(__file__).resolve().parents[1]))


# The rows that show a library call or torch.sum in the port's place.
CONTRASTS = ("batched call", "batched samples", "one torch.sum call")


@contextlib.contextmanager
def torch_sums():
    """Within the block, ``fixed_sum`` is ``torch.sum`` on the card too."""
    from gaussian_process_edge_trace_torch.ops import sums
    on_card = sums._on_card
    sums._on_card = lambda t: False
    try:
        yield
    finally:
        sums._on_card = on_card


def stages(cfg, data, state, z, w, blur, consts):
    """Every stage's output of one iteration, each from the outputs of the
    stage before it, as ``_iteration`` and ``fit_and_sample`` compute
    them."""
    import torch
    from gaussian_process_edge_trace_torch.models import gpr
    from gaussian_process_edge_trace_torch.models.kernels import (
        cross_gram, per_frame, train_gram)
    from gaussian_process_edge_trace_torch.ops.cuda_frames import (
        frames_product)
    from gaussian_process_edge_trace_torch.trace import driver as pd
    from gaussian_process_edge_trace_torch.trace.kde import curve_kde
    from gaussian_process_edge_trace_torch.trace.scoring import (
        best_curves, curve_costs)
    from gaussian_process_edge_trace_torch.trace.select import select_pixels
    out = {}
    x, y, mask, noise_w = pd._train_set(cfg, data, state)
    yf = y.to(torch.float32)
    out["std_raw one torch.sum call"] = gpr.masked_std(yf, mask)
    out["std_raw"] = std_raw = gpr.masked_std(yf, mask, gpr.frame_sum)
    y_s = std_raw + 1.0
    variance = cfg.sigma_f ** 2 / y_s ** 2
    diag_noise = cfg.noise_y * noise_w + cfg.gp_jitter
    s2 = std_raw / y_s
    post_scale = torch.where(s2 == 0.0, torch.ones_like(s2), s2)
    xs, ys = x.to(torch.float32), yf / y_s[..., None]
    zero = torch.zeros((), dtype=ys.dtype, device=ys.device)
    out["y_mean"] = y_mean = gpr.masked_mean(ys, mask, gpr.frame_sum)
    yc = torch.where(mask, ys - y_mean[..., None], zero)
    out["gram"] = K = train_gram(cfg.kernel, xs, cfg.sigma_l, variance,
                                 diag_noise, mask=mask)
    out["cholesky"] = L = gpr.safe_cholesky(K, jitter_scales=(0.0, 1e-3))
    Fz = data.L_prior_unit @ z
    scale = per_frame(torch.sqrt(variance))
    f0_x = scale * Fz[x] if Fz.dim() == 2 else None
    f0_grid = scale * Fz.index_select(-2, data.x_grid)
    eps = torch.sqrt(torch.clamp(diag_noise, min=0.0))[..., None] * w
    resid = torch.where(mask[..., None], yc[..., None] - f0_x - eps, zero)
    out["solve"] = A = torch.where(
        mask[..., None], gpr.backward_solve_auto(
            L, gpr.forward_solve_auto(L, resid)), zero)
    out["cholesky_solve batched call"] = A_lib = torch.where(
        mask[..., None], torch.cholesky_solve(resid, L), zero)
    Kq = cross_gram(cfg.kernel, data.x_grid.to(Fz.dtype), xs, cfg.sigma_l,
                    variance)
    Kq = torch.where(mask[..., None, :], Kq, zero)
    out["Kq @ A"] = frames_product(Kq, A)
    out["Kq @ A batched call"] = KA = Kq @ A_lib
    out["batched samples"] = (per_frame(y_mean) + per_frame(post_scale)
                              * (f0_grid + KA)) * per_frame(y_s)
    out["samples"] = samples = pd._sample_round(cfg, data, x, y, mask,
                                                noise_w, z, w)
    costs, samples_t = curve_costs(data.grad_cols, samples,
                                   kde_thresh=cfg.kde_thresh,
                                   return_samples_t=True)
    out["costs"] = costs
    with torch_sums():
        out["costs one torch.sum call"] = curve_costs(
            data.grad_cols, samples, kde_thresh=cfg.kde_thresh)
    bc, bcosts = best_curves(samples, costs, cfg.N_keep, samples_t=samples_t)
    out["kept curves"] = bc
    inv = 1.0 / bcosts
    out["weights one torch.sum call"] = inv / inv.sum(-1, keepdim=True)
    out["weights"] = weights = inv / gpr.frame_sum(inv)[..., None]
    out["kde"] = kde = curve_kde(bc, weights, cfg.M, cfg.N, cfg.x_st,
                                 blur=blur)
    sel = select_pixels(
        kde, data.grad_kde, torch.cat([state.user_x, state.obs_x], dim=-1),
        torch.cat([state.user_y, state.obs_y], dim=-1),
        torch.cat([state.user_valid, state.obs_valid], dim=-1),
        n_pre=state.n_fobs, score_thresh=state.score_thresh, spec=cfg.bins,
        fix_endpoints=cfg.fix_endpoints, kde_thresh=cfg.kde_thresh,
        pixel_thresh=cfg.pixel_thresh, algo_thresh=cfg.algo_thresh,
        max_decays=cfg.max_decays, consts=consts)
    out["selected x"] = sel.obs_x
    return out


def final_stages(cfg, data, state, draws, y_mean=None):
    """The final fit's results on ``state`` and the final cost of
    ``y_mean`` (default: the fit's own mean curves), as ``finish_trace``
    computes it, and with ``torch.sum`` in ``fixed_sum``'s place."""
    from gaussian_process_edge_trace_torch.trace import driver as pd
    from gaussian_process_edge_trace_torch.trace.scoring import curve_costs
    res = pd.finish_trace(cfg, data, state, draws)
    out = {f"final fit {k}": getattr(res, k)
           for k in ("y_mean", "y_std", "theta", "lml")}
    ys = (res.y_mean if y_mean is None else y_mean)[..., None]
    even = "avg" if cfg.legacy_simpson else "simpson"
    out["final cost"] = curve_costs(data.grad_cols, ys, cfg.kde_thresh,
                                    even)[..., 0]
    with torch_sums():
        out["final cost one torch.sum call"] = curve_costs(
            data.grad_cols, ys, cfg.kde_thresh, even)[..., 0]
    return out


def frame(tree, f, own):
    return type(tree)(**{k: v[f:f + 1] if k in own else v
                         for k, v in tree._asdict().items()})


def run(tag, configs, iters):
    import torch
    from gaussian_process_edge_trace_torch.parallel import (
        make_batch_data, make_batch_state)
    from gaussian_process_edge_trace_torch.trace import driver as pd
    from gaussian_process_edge_trace_torch.trace.kde import blur_matrices
    from gaussian_process_edge_trace_torch.trace.select import select_consts
    dev = configs[0].dev
    cfg = configs[0].tracer(1).cfg
    B = len(configs)
    data = make_batch_data(cfg, torch.stack([c.grad for c in configs]),
                           np.stack([c.init for c in configs]))
    state = make_batch_state(cfg, B, dev)
    draws = pd.StreamDraws(cfg, data.L_prior_unit.shape[1], dev)
    blur = blur_matrices(cfg.M, cfg.N, torch.float32, dev)
    consts = select_consts(cfg.bins, cfg.N, cfg.max_decays, dev)
    own_d = ("grad_img", "grad_kde", "grad_cols", "init_x", "init_y")
    rows = []

    def compare(k, whole, alone):
        for name, v in whole.items():
            diff = [f for f in range(B)
                    if not torch.equal(v[f], alone[f][name][0])]
            gap = max([(v[f].double() - alone[f][name][0].double()).abs()
                       .max().item() for f in diff] or [0.0])
            rows.append({"batch": tag, "iteration": k, "stage": name,
                         "contrast": name.endswith(CONTRASTS),
                         "frames_differing": len(diff), "max_abs": gap})
            print(f"[{tag}] iteration {k} {name:30s} frames differing from "
                  f"their single run: {len(diff):3d} of {B}, max |diff| "
                  f"{gap:.3e}", flush=True)

    fields = pd.TraceState._fields
    for k in range(iters):
        z, w = draws.normals(k)
        compare(k, stages(cfg, data, state, z, w, blur, consts),
                [stages(cfg, frame(data, f, own_d), frame(state, f, fields),
                        z, w, blur, consts) for f in range(B)])
        state, _ = pd._iteration(cfg, data, state, draws, k, (blur, consts))
    whole = final_stages(cfg, data, state, draws)
    compare("final", whole, [final_stages(
        cfg, frame(data, f, own_d), frame(state, f, fields), draws,
        y_mean=whole["final fit y_mean"][f:f + 1]) for f in range(B)])
    return rows


def main(argv=None):
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--demo-frames", type=int, default=16)
    p.add_argument("--big-frames", type=int, default=4)
    p.add_argument("--odd", action="store_true",
                   help="the right endpoint one column in: odd E")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()}")
    rows = []
    odd = "_oddE" if args.odd else ""
    for tag, make, n in ((f"demo{odd}_B{args.demo_frames}", cs.demo_config,
                          args.demo_frames),
                         (f"1000{odd}_B{args.big_frames}", cs.big_config,
                          args.big_frames)):
        if n:
            rows += run(tag, [make(dev, image_seed=i,
                                   right=-2 if args.odd else -1)
                              for i in range(1, n + 1)], args.iters)
    moved = sorted({(r["batch"], r["stage"]) for r in rows
                    if r["frames_differing"] and not r["contrast"]})
    print(f"[summary] every stage of the port bitwise each frame alone: "
          f"{not moved}{'' if not moved else f' (moved: {moved})'}")
    print(json.dumps(rows))
    return 1 if moved else 0


if __name__ == "__main__":
    sys.exit(main())
