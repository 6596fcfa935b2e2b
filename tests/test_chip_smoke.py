"""chip_smoke.py: every phase at tiny shapes on the CPU (the four-card
phase on 4 of the virtual devices), its refusal of a non-GPU platform, and
its choice of compile-cache directory."""
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_non_gpu(argv, capsys):
    assert jax.devices()[0].platform == "cpu"
    assert cs.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.mark.parametrize("env, expect", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({}, str(REPO / ".jax_cache")),
])
def test_compile_cache_dir(env, expect):
    assert cs.compile_cache_dir(env) == expect


def test_nvidia_smi_line_is_a_string():
    assert isinstance(cs.gpu_name_and_power_limit(), str)


def test_phase_compile_tiny():
    res = cs.phase_compile(cs.ucsv_sampler(16, 64, chain=2),
                           cs.synthetic_series(20))
    assert res["compile_s"] > 0
    assert res["memory_analysis"]["output_size_in_bytes"] > 0


def test_phase_end_to_end_tiny():
    res = cs.phase_end_to_end(cs.ucsv_sampler(16, 64, chain=2),
                              cs.synthetic_series(20), segment_size=4)
    assert res["segmented_bitwise"] and res["t"] == 20


def test_phase_kalman_vs_f64():
    assert cs.phase_kalman_vs_f64(t=200)["relative"] < 1e-4


def test_phase_batched_pf_vs_kalman_tiny():
    res = cs.phase_batched_pf_vs_kalman(n_theta=8, n=512, t=30, reps=6)
    assert abs(res["score_se"]) < 3


def test_phase_resample_gather_tiny():
    assert cs.phase_resample_gather(m=8, n=256)["n"] == 256


def test_phase_ibis_vs_smc2_tiny():
    res = cs.phase_ibis_vs_smc2(m=128, n=128, t=60, chain=2)
    assert len(res["ibis_mean"]) == 3


def test_phase_other_samplers_tiny():
    res = cs.phase_other_samplers(m=32, n_dt=64, n_pg=64, sweeps=2,
                                  n_smooth=64, t_lg=30, t_ucsv=30)
    assert set(res) == {"density_tempered", "particle_gibbs",
                        "smoothed_marginals"}


def test_phase_four_cards_virtual_mesh():
    res = cs.phase_four_cards(m=16, n=64, t=12, chain=2, n_elastic=32,
                              devices=jax.devices()[:4])
    assert res["mesh_4x1"]["run"]["posterior_mean_diff"] <= cs.THETA_MESH_MEAN_TOL
    for mesh in ("mesh_4x1", "mesh_2x2"):
        assert res[mesh]["steps"]["init"]["theta_rows_agree"] == 1.0
        assert res[mesh]["run"]["posterior_mean_diff_sd"] <= cs.MC_SD_TOL
    assert res["elastic_2x2"]["active_n"] > 32


class _OtherKey:
    """A stand-in for a faulty sharded sampler: the same sampler started
    from another key."""

    def __init__(self, sampler):
        self.sampler = sampler

    def init(self, key, y):
        return self.sampler.init(jax.random.fold_in(key, 1), y)

    def step(self, state, y):
        return self.sampler.step(state, y)


def test_four_card_check_rejects_a_different_run():
    y = cs.synthetic_series(12)
    with pytest.raises(cs.SmokeError, match="before any rejuvenation"):
        cs._require_exact_until_rejuvenation(
            "other key", cs.ucsv_sampler(16, 64, chain=2),
            _OtherKey(cs.ucsv_sampler(16, 64, chain=2)), y, max_steps=2)
