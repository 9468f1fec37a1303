"""The control, each configuration's reference in TF32 put in the program's place,
fails the limits that the program passes (the traffic files' own limits)."""

import pytest

import tiny
from portbench import calibrate


@pytest.mark.parametrize("workload", [w["name"] for w in tiny.BENCH["workloads"]])
def test_control_fails_where_the_program_passes(workload):
    mix = tiny.traffic(workload)
    program = calibrate.readings(tiny.BENCH, workload, 41, 4, False, device="cpu", traffic=mix)
    control = calibrate.readings(tiny.BENCH, workload, 41, 4, True, device="cpu", traffic=mix)
    assert program["rel_err"] <= mix["limits"]["rel_err"] and program["failed"] == 0
    assert control["rel_err"] > mix["limits"]["rel_err"] and control["failed"] > 0
    assert program["bad_chunks"] == control["bad_chunks"] == 0
