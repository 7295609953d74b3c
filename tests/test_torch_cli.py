"""PyTorch port, the CLI (``python -m gaussian_process_edge_trace_torch``)
on the CPU through ``--device cpu``: ``trace``, ``batch`` and ``batch
--sequence`` on a small image, each ``.npz`` and JSON line bit for bit the
in-process ``GP_Edge_Tracing`` / ``trace_batch`` / ``trace_sequence``; the
help through ``python -m``; and the refusal, by name, of what needs
matplotlib where it is missing."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch.__main__ import main
from gaussian_process_edge_trace_torch.parallel import (
    make_batch_data, make_batch_state, trace_batch, trace_sequence)
from gaussian_process_edge_trace_torch.trace.driver import make_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 96
KW = dict(kernel_options={"kernel": "RBF", "sigma_f": 20,
                          "length_scale": 8},
          noise_y=1.0, N_samples=64, score_thresh=1.0, delta_x=5,
          keep_ratio=0.1, pixel_thresh=5, seed=3, fix_endpoints=True)
FLAGS = ["--sigma-f", "20", "--length-scale", "8", "--n-samples", "64",
         "--seed", "3", "--device", "cpu"]


def _image(seed):
    img, edge = gpt.construct_test_img((H, W), 15, 2, 0.03, "sinusoidal",
                                       0.3, gaps=False, seed=seed)
    return np.asarray(img), edge


def _init(edge):
    return np.array([[0, edge[0, 0]], [W - 1, edge[W - 1, 0]]])


def _init_flags(init):
    return ["--init", f"{init[0, 0]},{init[0, 1]}",
            f"{init[1, 0]},{init[1, 1]}"]


def _grad(img):
    return gpt.comp_grad_img(img, gpt.kernel_builder((11, 5)), device="cpu")


def _lines(capsys):
    return [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]


def test_trace_equals_the_api(tmp_path, capsys):
    img, edge = _image(1)
    init = _init(edge)
    np.save(tmp_path / "img.npy", img)
    out = tmp_path / "res.npz"
    main(["trace", str(tmp_path / "img.npy"), *_init_flags(init), *FLAGS,
          "--out", str(out)])
    line = _lines(capsys)[-1]
    tracer = gpt.GP_Edge_Tracing(init, _grad(img), return_std=True,
                                 device="cpu", **KW)
    edge_pred, (lo, hi) = tracer()
    res = tracer.last_result
    z = np.load(out)
    want = dict(edge_trace=edge_pred, cred_lower=lo, cred_upper=hi,
                y_mean=res.y_mean.numpy(),
                cred_px=res.cred_interval_px.numpy(),
                n_iters=np.asarray(res.n_iters),
                theta=np.exp(res.theta.numpy()))
    assert sorted(z.files) == sorted(want)
    for k, v in want.items():
        assert z[k].dtype == v.dtype, k
        np.testing.assert_array_equal(z[k], v, err_msg=k)
    assert line.pop("wall_s") >= 0
    assert line == {"out": str(out), "n_iters": int(res.n_iters),
                    "converged": bool(res.converged),
                    "lml": round(float(res.lml), 3)}
    assert gpt.trace_dicecoef(z["edge_trace"], edge) > 0.9


@pytest.mark.parametrize("sequence", [False, True])
def test_batch_equals_trace_batch_and_sequence(tmp_path, capsys, sequence):
    frames = tmp_path / "frames"
    frames.mkdir()
    imgs = []
    for f in range(3):
        img, edge = _image(f + 1)
        imgs.append(img)
        np.save(frames / f"f{f}.npy", img)
    init = _init(edge)
    out_dir = tmp_path / "out"
    main(["batch", str(frames / "*.npy"), *_init_flags(init), *FLAGS,
          "--out-dir", str(out_dir)] + (["--sequence"] if sequence else []))
    lines = _lines(capsys)
    summary = lines.pop()
    assert summary["frames"] == 3 and summary["wall_s"] >= 0
    assert summary["mode"] == ("sequence" if sequence else "batch")

    grads = torch.stack([_grad(i) for i in imgs])
    inits = np.broadcast_to(init, (3,) + init.shape)
    cfg = make_config(init, (H, W), **KW)
    if sequence:
        want = [(r.edge_trace.numpy(), int(r.n_iters), bool(r.converged))
                for r in trace_sequence(cfg, grads, inits)]
    else:
        res = trace_batch(cfg, make_batch_data(cfg, grads, inits),
                          make_batch_state(cfg, 3, "cpu"))
        want = [(res.edge_trace[f].numpy(), int(res.n_iters[f]),
                 bool(res.converged[f])) for f in range(3)]
    for f, (line, (trace, n_it, conv)) in enumerate(zip(lines, want)):
        out = str(out_dir / f"f{f}_trace.npz")
        assert line == {"image": str(frames / f"f{f}.npy"), "out": out,
                        "n_iters": n_it, "converged": conv}
        got = np.load(out)["edge_trace"]
        assert got.dtype == trace.dtype
        np.testing.assert_array_equal(got, trace)


def test_help_through_python_m():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = subprocess.run(
        [sys.executable, "-m", "gaussian_process_edge_trace_torch", "--help"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert done.returncode == 0, done.stderr
    for word in ("trace", "batch", "demo", "--compilation-cache"):
        assert word in done.stdout
    done = subprocess.run(
        [sys.executable, "-m", "gaussian_process_edge_trace_torch", "trace",
         "--help"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=120)
    assert done.returncode == 0 and "--device" in done.stdout


def test_demo_points_to_the_example():
    with pytest.raises(SystemExit, match="examples.demo"):
        main(["demo"])


def test_missing_matplotlib_is_refused_by_name(tmp_path, monkeypatch):
    """An image file other than ``.npy`` and ``--plot`` need matplotlib;
    without it each raises an ImportError that names it."""
    img, edge = _image(1)
    np.save(tmp_path / "img.npy", img)
    (tmp_path / "img.png").write_bytes(b"not read")
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    args = [*_init_flags(_init(edge)), *FLAGS]
    with pytest.raises(ImportError, match="matplotlib"):
        main(["trace", str(tmp_path / "img.png"), *args])
    with pytest.raises(ImportError, match="matplotlib"):
        main(["trace", str(tmp_path / "img.npy"), *args,
              "--plot", str(tmp_path / "fig.png"), "--out",
              str(tmp_path / "r.npz")])
    assert not (tmp_path / "r.npz").exists()
