"""PipelineConfig (SURVEY.md §5.6): frozen, serializable, runnable."""

import numpy as np
import pytest

from richdem_tpu import synth
from richdem_tpu.config import PipelineConfig


def test_frozen_and_roundtrip():
    cfg = PipelineConfig(eps=1e-3, metric="Quinn", exponent=1.0,
                         mesh=(2, 4))
    with pytest.raises(dataclasses_error()):
        cfg.eps = 0.0
    back = PipelineConfig.from_json(cfg.to_json())
    assert back == cfg
    assert hash(cfg) == hash(back)


def dataclasses_error():
    import dataclasses
    return dataclasses.FrozenInstanceError


def test_run_d8(tmp_path):
    dem = synth.depression_dem(48, seed=7, dtype=np.float32)
    cfg = PipelineConfig(eps=0.0, with_twi=True,
                         cache_dir=str(tmp_path / "c"))
    out = cfg.run(dem)
    fd = np.asarray(out["flowdirs"])
    assert np.asarray(out["accum"])[fd == 0].sum() == dem.size
    assert "twi" in out


def test_run_mfd():
    dem = synth.depression_dem(48, seed=7, dtype=np.float32)
    cfg = PipelineConfig(eps=1e-3, metric="Quinn")
    out = cfg.run(dem)
    assert np.asarray(out["accum"]).sum() > 0


def test_per_config_pinned_baseline_dispatch(tmp_path, monkeypatch):
    """bench.pinned_baseline picks the config-matched pin, falls back to
    the pipeline figure (tagged) for configs missing from the file, and
    honours the env override."""
    import json
    import bench

    pin = {"cells_per_s": 5.5e6,
           "configs": {"pipeline": 5.5e6, "dinf_twi": 3.5e6}}
    path = tmp_path / "pin.json"
    path.write_text(json.dumps(pin))
    monkeypatch.setattr(bench, "PINNED_PATH", str(path))
    monkeypatch.delenv("BENCH_BASELINE_CELLS_S", raising=False)

    assert bench.pinned_baseline("pipeline") == (5.5e6, "pinned")
    assert bench.pinned_baseline("dinf_twi") == (3.5e6, "pinned")
    assert bench.pinned_baseline("quinn_mfd") == (
        5.5e6, "pinned-pipeline")
    monkeypatch.setenv("BENCH_BASELINE_CELLS_S", "1e6")
    assert bench.pinned_baseline("dinf_twi") == (1e6, "env")
