"""Engine integration: full train->val->checkpoint->resume cycles on tiny
synthetic data for both tracks (the operational-validation strategy of the
reference, SURVEY.md §4, as fast tests)."""

import glob
import os

import numpy as np
import pytest

from mvp_benchmark_tpu.train import checkpoint as ckpt
from mvp_benchmark_tpu.train import engine
from mvp_benchmark_tpu.train.config import Config


def completion_cfg(**kw):
    base = dict(
        model_name="pcn", batch_size=4, nepoch=2, num_points=32,
        num_coarse=16, loss="cd", eval_emd=False, manual_seed=1,
        lr=1e-4, lr_decay=True, lr_decay_interval=40, lr_decay_rate=0.7,
        lr_clip=1e-6, optimizer="Adam", betas="0.9, 0.999", weight_decay=0,
        varying_constant="0.01, 0.1, 0.5, 1",
        varying_constant_epochs="5, 15, 30",
        step_interval_to_print=100, epoch_interval_to_save=1,
        epoch_interval_to_val=1, start_epoch=0,
    )
    base.update(kw)
    return Config(base)


def registration_cfg(**kw):
    base = dict(
        model_name="dcp", batch_size=4, nepoch=1, num_points=32,
        manual_seed=1, lr=1e-3, lr_decay=True, lr_decay_rate=0.5,
        lr_clip=1e-6, optimizer="Adam", betas="0.9, 0.999", weight_decay=0,
        max_angle=45, max_trans=0.5, category=None,
        num_rot_levels=2, num_corr_levels=2,
        step_interval_to_print=100, epoch_interval_to_save=1,
        epoch_interval_to_val=1, start_epoch=0, benchmark="mvp",
    )
    base.update(kw)
    return Config(base)


def test_completion_train_val_checkpoint(tmp_path, monkeypatch):
    # Point the engine at a guaranteed-synthetic data dir.
    cfg = completion_cfg()
    out = engine.train_completion(cfg, str(tmp_path),
                                  data_dir=str(tmp_path / "nodata"),
                                  max_steps_per_epoch=3)
    assert len(out["history"]["train_loss"]) == 2
    assert all(np.isfinite(v) for v in out["history"]["train_loss"])
    assert (tmp_path / "network.pkl").exists()
    best = glob.glob(str(tmp_path / "best_*_network.pkl"))
    # cd_p/cd_t always improve from +inf; f1 only saves when it strictly
    # beats 0.0 (reference semantics) which tiny synthetic data may not hit.
    assert len(best) >= 2
    # best-metric bookkeeping is populated
    for m, (ep, val) in out["best"].items():
        assert np.isfinite(val)

    # resume: epoch 2..3 with loaded weights
    cfg2 = completion_cfg(
        load_model=str(tmp_path / "network.pkl"), start_epoch=2, nepoch=3
    )
    out2 = engine.train_completion(cfg2, str(tmp_path),
                                   data_dir=str(tmp_path / "nodata"),
                                   max_steps_per_epoch=2)
    assert len(out2["history"]["train_loss"]) == 1


def test_registration_train_val_split_meters(tmp_path):
    cfg = registration_cfg()
    out = engine.train_registration(cfg, str(tmp_path),
                                    data_dir=str(tmp_path / "nodata"),
                                    max_steps_per_epoch=3)
    assert len(out["history"]["train_loss"]) == int(cfg.nepoch)
    assert all(np.isfinite(v) for v in out["history"]["train_loss"])
    val = out["history"]["val"][-1]
    assert set(val) == {"RotE", "transE", "MSE", "RMSE", "recall"}
    assert 0.0 <= val["recall"] <= 1.0
    assert val["RotE"] >= 0.0
    assert (tmp_path / "best_RMSE_network.pkl").exists()


def test_checkpoint_contains_opt_state(tmp_path):
    cfg = completion_cfg(nepoch=1)
    engine.train_completion(cfg, str(tmp_path),
                            data_dir=str(tmp_path / "nodata"),
                            max_steps_per_epoch=1)
    payload = ckpt.load_model(str(tmp_path / "network.pkl"))
    assert "net_state_dict" in payload and "opt_state" in payload
    assert "params" in payload["net_state_dict"]
