"""Unit tests: LR schedules, alpha schedule, meters, config, checkpointing,
dataset batching semantics."""

import os

import numpy as np
import pytest

from mvp_benchmark_tpu.data.mvp import (
    BatchSpec,
    MVPCompletionDataset,
    MVPRegistrationDataset,
    VIEWS_PER_MODEL,
)
from mvp_benchmark_tpu.train import checkpoint as ckpt
from mvp_benchmark_tpu.train import optim
from mvp_benchmark_tpu.train.config import Config, parse_float_list, parse_int_list
from mvp_benchmark_tpu.train.meters import AverageValueMeter


class TestSchedules:
    def test_interval_decay(self):
        """Reference semantics (completion/train.py:110-120): x0.7 every 40
        epochs, clipped at lr_clip."""
        cfg = Config(lr=1e-4, lr_decay=True, lr_decay_interval=40,
                     lr_decay_rate=0.7, lr_clip=1e-6)
        assert optim.epoch_lr(cfg, 0) == 1e-4
        assert optim.epoch_lr(cfg, 39) == 1e-4
        np.testing.assert_allclose(optim.epoch_lr(cfg, 40), 0.7e-4)
        np.testing.assert_allclose(optim.epoch_lr(cfg, 80), 0.49e-4)
        big = Config(lr=1e-4, lr_decay=True, lr_decay_interval=1,
                     lr_decay_rate=0.1, lr_clip=1e-6)
        assert optim.epoch_lr(big, 100) == 1e-6  # clipped

    def test_step_decay(self):
        cfg = Config(lr=1.0, lr_decay=True, lr_step_decay_epochs="10, 20",
                     lr_step_decay_rates="0.5, 0.1", lr_clip=None)
        assert optim.epoch_lr(cfg, 5) == 1.0
        assert optim.epoch_lr(cfg, 10) == 0.5
        assert optim.epoch_lr(cfg, 25) == 0.05

    def test_alpha_schedule(self):
        """Reference semantics (completion/train.py:101-108)."""
        cfg = Config(varying_constant="0.01, 0.1, 0.5, 1",
                     varying_constant_epochs="5, 15, 30")
        assert optim.alpha_for_epoch(cfg, 0) == 0.01
        assert optim.alpha_for_epoch(cfg, 4) == 0.01
        assert optim.alpha_for_epoch(cfg, 5) == 0.1
        assert optim.alpha_for_epoch(cfg, 29) == 0.5
        assert optim.alpha_for_epoch(cfg, 30) == 1.0
        assert optim.alpha_for_epoch(cfg, 99) == 1.0
        assert optim.alpha_for_epoch(Config(), 3) is None

    def test_plateau(self):
        s = optim.PlateauScheduler(lr=1.0, factor=0.5, min_lr=0.1, patience=2)
        for m in [5.0, 4.0, 4.0, 4.0]:
            lr = s.step(m)
        assert lr == 1.0  # patience not exceeded yet (2 bad epochs)
        lr = s.step(4.0)  # 3rd bad epoch -> decay
        assert lr == 0.5


class TestMetersConfig:
    def test_meter(self):
        m = AverageValueMeter()
        m.update(1.0)
        m.update(2.0, n=3)
        np.testing.assert_allclose(m.avg, 7.0 / 4.0)
        m.reset()
        assert m.count == 0

    def test_config_attr_access(self, tmp_path):
        p = tmp_path / "c.yaml"
        p.write_text("a: 1\nb: hello\nnested:\n  c: 2\n")
        from mvp_benchmark_tpu.train.config import load_config

        cfg = load_config(str(p), extra=5)
        assert cfg.a == 1 and cfg.b == "hello"
        assert cfg.nested.c == 2
        assert cfg.extra == 5
        assert cfg.missing_key is None

    def test_parse_lists(self):
        assert parse_int_list("1, 2, 3") == [1, 2, 3]
        assert parse_int_list(7) == [7]
        assert parse_float_list("0.1,0.2") == [0.1, 0.2]
        assert parse_int_list(None) == []


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        import jax.numpy as jnp

        tree = {"params": {"w": jnp.ones((3, 3)), "b": jnp.zeros(3)}}
        path = str(tmp_path / "net.pkl")
        ckpt.save_model(path, tree, opt_state={"step": jnp.asarray(5)})
        loaded = ckpt.load_model(path)
        assert set(loaded) == {"net_state_dict", "opt_state"}
        np.testing.assert_array_equal(
            loaded["net_state_dict"]["params"]["w"], np.ones((3, 3))
        )


class TestDatasets:
    def test_completion_gt_indexing(self):
        """gt for partial i is complete[i // 26] (completion/dataset.py:42)."""
        ds = MVPCompletionDataset("train", num_points=32, synthetic_size=52)
        batch = ds._get_batch(np.array([0, 25, 26, 51]))
        np.testing.assert_array_equal(batch["gt"][0], batch["gt"][1])
        np.testing.assert_array_equal(batch["gt"][2], batch["gt"][3])
        assert not np.array_equal(batch["gt"][0], batch["gt"][2])

    def test_padded_final_batch(self):
        ds = MVPCompletionDataset("val", num_points=16, synthetic_size=26)
        spec = BatchSpec(8)
        batches = list(ds.batches(spec))
        assert len(batches) == 4
        counts = [int(b["count"]) for b in batches]
        assert counts == [8, 8, 8, 2]
        assert all(b["inputs"].shape == (8, 16, 3) for b in batches)
        assert ds.steps_per_epoch(spec) == 4

    def test_shuffle_determinism_and_epoch_variation(self):
        ds = MVPCompletionDataset("train", num_points=16, synthetic_size=52)
        spec = BatchSpec(8, shuffle=True, seed=3, drop_last=True)
        a = [b["inputs"] for b in ds.batches(spec, epoch=0)]
        b = [b["inputs"] for b in ds.batches(spec, epoch=0)]
        c = [b["inputs"] for b in ds.batches(spec, epoch=1)]
        np.testing.assert_array_equal(a[0], b[0])
        assert not np.array_equal(a[0], c[0])

    def test_host_sharding_partitions(self):
        ds = MVPCompletionDataset("val", num_points=16, synthetic_size=52)
        seen = []
        for shard in range(2):
            spec = BatchSpec(4, num_shards=2, shard_id=shard)
            for b in ds.batches(spec):
                seen.append(b["inputs"][: int(b["count"])])
        total = sum(s.shape[0] for s in seen)
        assert total == 52

    def test_registration_val_consistency(self):
        """Synthetic val split: tgt must equal src under the stored pose."""
        ds = MVPRegistrationDataset("val", max_angle=45.0, max_trans=0.5,
                                    num_points=24, synthetic_size=8)
        b = ds._get_batch(np.arange(4))
        R = b["transform"][:, :3, :3]
        t = b["transform"][:, :3, 3]
        pred = np.einsum("bij,bnj->bni", R, b["src"]) + t[:, None, :]
        np.testing.assert_allclose(pred, b["tgt"], atol=1e-5)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHIPPED_CFGS = sorted(
    os.path.relpath(os.path.join(d, f), _REPO)
    for d in (os.path.join(_REPO, "completion", "cfgs"),
              os.path.join(_REPO, "registration", "cfgs"))
    for f in os.listdir(d) if f.endswith(".yaml"))


class TestConfigParser:
    def test_every_shipped_cfg_is_listed(self):
        assert len(_SHIPPED_CFGS) == 12

    @pytest.mark.parametrize("rel", _SHIPPED_CFGS)
    def test_shipped_cfg_parses_like_yaml(self, rel):
        """Same keys, values and types as a YAML library gives."""
        from mvp_benchmark_tpu.train.config import load_config

        yaml = pytest.importorskip("yaml")
        path = os.path.join(_REPO, rel)
        with open(path) as f:
            want = yaml.safe_load(f)
        got = dict(load_config(path))
        assert got == want
        for k, v in want.items():
            assert type(got[k]) is type(v), k

    def test_scalars_comments_and_nesting(self):
        from mvp_benchmark_tpu.train.config import parse_yaml_mapping

        text = ("# header\nlr: 1.e-6  # trailing\nname: 'a: b' # c\n"
                "q: \"16\"\nflag: True\noff: False\nnone: null\nempty:\n"
                "betas: 0.9, 0.999\nouter:\n  inner:\n    k: 3\n  j: -2\n"
                "last: .5\n")
        assert parse_yaml_mapping(text) == {
            "lr": 1e-6, "name": "a: b", "q": "16", "flag": True,
            "off": False, "none": None, "empty": None,
            "betas": "0.9, 0.999", "outer": {"inner": {"k": 3}, "j": -2},
            "last": 0.5}

    @pytest.mark.parametrize("text", ["a: 1\n  b: 2\n", "a:\n  b: 1\n c: 2\n",
                                      "- item\n", "x: 'open\n"])
    def test_rejects_what_it_does_not_read(self, text):
        from mvp_benchmark_tpu.train.config import parse_yaml_mapping

        with pytest.raises(ValueError):
            parse_yaml_mapping(text)


def test_main_path_needs_no_flax_yaml_or_h5py():
    """The train/test entry modules import with flax, PyYAML and h5py
    blocked (h5py is imported only when a results file is written)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "for m in ('flax', 'yaml', 'h5py'): sys.modules[m] = None\n"
            "import mvp_benchmark_tpu.train.engine, "
            "mvp_benchmark_tpu.train.submission, mvp_benchmark_tpu.models\n")
    subprocess.run([sys.executable, "-c", code], cwd=_REPO, check=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))


class TestCompileCache:
    def _cache_dir(self, env):
        import subprocess
        import sys

        code = ("import mvp_benchmark_tpu, jax; "
                "print(jax.config.jax_compilation_cache_dir)")
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                             capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()[-1]

    def test_env_dir_wins(self, tmp_path):
        env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
        assert self._cache_dir(env) == str(tmp_path)

    def test_default_is_fixed_dir_in_checkout(self):
        import mvp_benchmark_tpu

        env = {k: v for k, v in os.environ.items()
               if k != "JAX_COMPILATION_CACHE_DIR"}
        got = self._cache_dir(env)
        assert got == mvp_benchmark_tpu.DEFAULT_CACHE_DIR
        assert got == os.path.join(_REPO, ".jax_cache")
        with open(os.path.join(_REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
