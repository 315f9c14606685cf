"""The port's Module2 GAN convergence run (``train/gan_convergence.py``)
with its stand-in frozen nets (``train/standin_frozen.py``), on the CPU:
``standin_frozen.main`` at a tiny size, then a 4 + 2-step ``--device cpu``
run of ``run_training`` at ngf 8 with those stand-ins, the loss log
continuous across the resume and finite. The rest of the tools' checks
against the JAX package are in ``tests/test_torch_gan_convergence.py``
(this file was split off so that the two halves run on two workers).
"""
import os

import numpy as np

from animateportrait_tpu_torch.train import gan_convergence as tgc
from animateportrait_tpu_torch.train import standin_frozen as tsf


def test_standins_then_a_resumed_cpu_run(tmp_path):
    """``standin_frozen.main`` at 2 steps each over 8 faces and 2 x 4
    identities, then 4 + 2 steps of the GAN at ngf 8, crop 64, with them:
    the stand-ins load natively, the log runs 1..6 across the resume."""
    import subprocess

    frozen = str(tmp_path / "frozen")
    summary = tsf.main([frozen, "--steps", "2", "--sphere_steps", "2",
                        "--n_faces", "8", "--ids", "2", "--per_id", "4",
                        "--device", "cpu"])
    assert {"mobilefacenet.flax.npz", "sphere.flax.npz", "summary.json",
            "train_log.txt"} <= set(os.listdir(frozen))
    assert np.isfinite(summary["mfn_val_px_err"])
    assert 0 <= summary["sphere_val_acc"] <= 1

    root, ckpt = str(tmp_path / "drawing"), str(tmp_path / "ckpt")
    tgc.build_dataset(root)
    out = []
    real_run = subprocess.run

    def run(cmd, **kw):
        assert cmd[1:3] == ["-m", "animateportrait_tpu_torch.train_cli"]
        done = real_run(cmd, capture_output=True, text=True, **kw)
        out.append(done.stdout)
        return done

    subprocess.run = run
    try:
        tgc.run_training(root, ckpt, 64, 4, 6, 4, 8, print_freq=1,
                         frozen_dir=frozen, device="cpu")
    finally:
        subprocess.run = real_run
    assert len(out) == 2 and "[train] resumed from step 4" in out[1]
    for o in out:
        assert "frozen mobilefacenet: native" in o
        assert "frozen sphere: native" in o
    rows = tgc.read_metrics(ckpt)
    assert [r["iters"] for r in rows] == [1, 2, 3, 4, 5, 6]
    assert [r["epoch"] for r in rows] == [1, 1, 1, 1, 2, 2]
    for r in rows:
        assert np.isfinite([v for k, v in r.items()]).all()
        assert {"warp_B", "geom_B", "iden_B", "D_A", "G_A"} <= set(r)
