"""benchmarks/profile_step.py: the HLO scope attribution and the trace
reduction, on a CPU trace."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))

import profile_step as ps  # noqa: E402

HLO = """\
%fused_computation (p0: f32[4]) -> f32[4] {
  %p0 = f32[4]{0} parameter(0)
  %exp.1 = f32[4]{0} exponential(%p0), metadata={op_name="jit(f)/while/body/pf_resample/exp"}
  ROOT %add.2 = f32[4]{0} add(%exp.1, %exp.1), metadata={op_name="jit(f)/while/body/pf_normalize/add"}
}

%wrapped_computation (p1: f32[4]) -> f32[4] {
  %p1 = f32[4]{0} parameter(0)
  ROOT %neg.3 = f32[4]{0} negate(%p1), metadata={op_name="jit(f)/while/body/pf_propagate/pf_reweight/neg"}
}

ENTRY %main (x: f32[4]) -> f32[4] {
  %x = f32[4]{0} parameter(0)
  %fusion.1 = f32[4]{0} fusion(%x), kind=kLoop, calls=%fused_computation, metadata={op_name="jit(f)/while/body/pf_normalize/add"}
  %wrapped = f32[4]{0} fusion(%fusion.1), kind=kLoop, calls=%wrapped_computation
  ROOT %copy.4 = f32[4]{0} copy(%wrapped)
}
"""


def test_hlo_scopes_labels():
    s = ps.hlo_scopes(HLO)
    assert s["fusion.1"] == ("pf_normalize", "pf_resample+pf_normalize")
    assert s["wrapped"] == ("pf_reweight", "pf_reweight")
    assert s["copy.4"] == ("other", "other")
    assert s["copy_4"] == s["copy.4"]  # the GPU kernel-name form


def test_profile_reduces_cpu_trace():
    res = ps.profile(4, 128, 2, plane_prefix="/host:CPU", top=4)
    us = res["us_per_step"]
    assert us.get("pf_resample", 0) > 0 and us.get("pf_propagate", 0) > 0
    assert res["busy_us_per_step"] > 0 and len(res["top_kernels"]) == 4
