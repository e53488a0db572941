"""``gridgen.calibrate_auto`` of the port (the JAX package's
tests/test_gridgen.py::test_auto_calibration on the port), on the CPU.

The measurement's workload is shrunk (icosphere(1), 8³ / 12³ grids, where
the JAX test times icosphere(4) at 48³ and 96³): the port's CPU routes run
the kernels' plain versions, minutes at the full workload; the sizes are
module constants for this reason.
"""
import json

import pytest
import torch

import mesh_to_sdf_tpu_torch.gridgen as gg

CPU = torch.device("cpu")


@pytest.fixture
def small_calibration(monkeypatch, tmp_path):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.delenv("M2S_AUTO_CALIBRATE", raising=False)
    for name in ("M2S_AUTO_DENSE_PAIRS_PER_S", "M2S_AUTO_CPT_OVERHEAD_S",
                 "M2S_AUTO_CPT_CELLS_PER_S"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(gg, "CAL_LEVEL", 1)
    monkeypatch.setattr(gg, "CAL_DENSE_CELLS", 8)
    monkeypatch.setattr(gg, "CAL_CPT_CELLS", (8, 12))
    gg._AUTO_CAL_CACHE.clear()
    yield tmp_path
    gg._AUTO_CAL_CACHE.clear()


def test_auto_calibration(small_calibration, monkeypatch):
    """calibrate_auto measures sane constants, persists them under the
    device's key, and AUTO consumes the calibration."""
    assert gg._auto_constants(CPU) == gg._AUTO_DEFAULTS["cpu"]
    dense_pairs, cpt_overhead, cpt_cells = gg.calibrate_auto(force=True,
                                                             device="cpu")
    assert dense_pairs > 0 and cpt_cells > 0 and cpt_overhead >= 0
    path = small_calibration / "mesh_to_sdf_tpu_torch" / "auto_cal.json"
    assert json.loads(path.read_text()) == {
        "cpu": [dense_pairs, cpt_overhead, cpt_cells]}
    # Cached on disk: a fresh in-process cache still finds it.
    gg._AUTO_CAL_CACHE.clear()
    again = gg.calibrate_auto(device="cpu")
    assert again == (dense_pairs, cpt_overhead, cpt_cells)
    # Without the opt-in, a calibration made in this process is used ...
    assert gg._auto_constants(CPU) == again
    gg._AUTO_CAL_CACHE.clear()
    assert gg._auto_constants(CPU) == gg._AUTO_DEFAULTS["cpu"]
    # ... with it, the calibration (here from the disk cache) ...
    monkeypatch.setenv("M2S_AUTO_CALIBRATE", "1")
    assert gg._auto_constants(CPU) == again
    # ... and the environment overrides both.
    monkeypatch.setenv("M2S_AUTO_CPT_OVERHEAD_S", "7.5")
    assert gg._auto_constants(CPU) == (dense_pairs, 7.5, cpt_cells)


def test_failed_calibration_raises(small_calibration, monkeypatch):
    """A measurement that fails raises through AUTO (no silent defaults)."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(gg, "generate_grid_sdf", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        gg.calibrate_auto(force=True, device="cpu")
    monkeypatch.setenv("M2S_AUTO_CALIBRATE", "1")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        gg._auto_constants(CPU)


def test_module_constants_are_the_cuda_defaults():
    assert (gg.AUTO_DENSE_PAIRS_PER_S, gg.AUTO_CPT_OVERHEAD_S,
            gg.AUTO_CPT_CELLS_PER_S) == gg._AUTO_DEFAULTS["cuda"]
    assert gg._device_key(CPU) == "cpu"
