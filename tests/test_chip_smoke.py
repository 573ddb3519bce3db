"""chip_smoke.py's phases at tiny sizes on the CPU, and its device check.

The phases are the script's own functions; each raises when a gate fails.
On the CPU they run at sizes that take seconds; the script itself runs them
at the reference's sizes on a GPU.
"""

import io
import contextlib

import pytest

import chip_smoke


def test_phase_sep_tiny():
    gates = chip_smoke.phase_sep(96, seed=1)
    assert gates["schur_residual_u"] < chip_smoke.WARN_U
    assert gates["eigenvector_residual_u"] < chip_smoke.WARN_U


def test_phase_gep_tiny():
    gates = chip_smoke.phase_gep(40, seed=1)
    assert gates["schur_residual_u"] < chip_smoke.WARN_U


def test_phase_sep_f32_tiny():
    gates = chip_smoke.phase_sep_f32(80, seed=1)
    assert gates["dtype"] == "float32"


def test_phase_sep_dm_four_devices():
    """The --multi phase on four of the suite's virtual CPU devices, above
    the small limit so the shard_map driver runs."""
    gates = chip_smoke.phase_sep_dm(144, ndev=4, seed=1)
    assert gates["S_devices"] == 4 and gates["Q_reordered_devices"] == 4


def test_device_check_refuses_cpu():
    info = chip_smoke.device_info()
    assert info["platform"] == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(info)
    assert e.value.code not in (0, None)
    # the whole script stops before any phase and prints no result line
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert "phase" not in out.getvalue()
    assert '"ok"' not in out.getvalue()
