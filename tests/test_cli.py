"""CLI end-to-end (tiny run) and argument handling."""

import numpy as np
import pytest

from cuda_iblb_11_tpu.cli import main


def test_cli_runs_and_writes_outputs(tmp_path):
    rc = main([
        "1", "4", "48", "1.0", "1.0", "5", "0.002", "2", "0", "0",
        "--output", str(tmp_path), "--quiet", "--dtype", "float32",
    ])
    assert rc == 0
    flux = np.loadtxt(tmp_path / "Flux" / "1_4_48_1_1x5-flux.dat")
    assert flux.shape == (3, 2)  # samples at 0, 100 + final at 200
    assert (tmp_path / "Raw" / "4" / "1" / "SimLog.txt").exists()


def test_cli_platform_flag(tmp_path):
    # --platform cpu pins the jax platform in-process before first
    # backend use (the way to run the f64 CPU oracle on a GPU host).
    # Under the test env the platform is already cpu, so this asserts the
    # flag parses, applies, and the run still completes end-to-end.
    rc = main([
        "1", "4", "48", "1.0", "1.0", "5", "0.002", "2", "0", "0",
        "--output", str(tmp_path), "--quiet", "--platform", "cpu",
    ])
    assert rc == 0
    import jax

    assert jax.default_backend() == "cpu"
    assert (tmp_path / "Flux" / "1_4_48_1_1x5-flux.dat").exists()


def test_cli_mucus_pattern(tmp_path):
    # --pattern mucus selects the A_mn/B_mn tables the reference keeps
    # commented out (main.cu:36-54): must run end-to-end and produce a
    # DIFFERENT flux than the default beat
    args = ["1", "4", "48", "1.0", "1.0", "5", "0.002", "2", "0", "0",
            "--quiet", "--dtype", "float64"]
    assert main(args + ["--output", str(tmp_path / "nm")]) == 0
    assert main(args + ["--output", str(tmp_path / "mu"),
                        "--pattern", "mucus"]) == 0
    a = (tmp_path / "nm" / "Flux" / "1_4_48_1_1x5-flux.dat").read_text()
    b = (tmp_path / "mu" / "Flux" / "1_4_48_1_1x5-flux.dat").read_text()
    assert a != b
    log = (tmp_path / "mu" / "Raw" / "4" / "1" / "SimLog.txt").read_text()
    assert "Pattern: mucus" in log


def test_cli_mesh_flux_matches_single_device(tmp_path):
    # Multi-chip CLI (BASELINE config 5 wiring): an end-to-end --mesh 2,4
    # run on the 8-device CPU mesh must write a flux.dat identical to the
    # single-device run (f64 so the 6-sig-digit formatting can't waver).
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    args = ["1", "4", "48", "1.0", "1.0", "5", "0.002", "2", "0", "0",
            "--quiet", "--dtype", "float64"]
    assert main(args + ["--output", str(tmp_path / "single")]) == 0
    assert main(args + ["--output", str(tmp_path / "mesh"),
                        "--mesh", "2,4"]) == 0
    a = (tmp_path / "single" / "Flux" / "1_4_48_1_1x5-flux.dat").read_text()
    b = (tmp_path / "mesh" / "Flux" / "1_4_48_1_1x5-flux.dat").read_text()
    assert a == b
    log = (tmp_path / "mesh" / "Raw" / "4" / "1" / "SimLog.txt").read_text()
    assert "Mesh: 2,4" in log


def test_cli_mesh_resume_from_single_device_checkpoint(tmp_path):
    # Sharded-aware checkpointing: a single-device checkpoint resumes onto
    # a device mesh (place_state re-device_puts onto the mesh).
    import os

    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    args = ["1", "4", "48", "1.0", "1.0", "5", "0.002", "2", "0", "0",
            "--quiet", "--dtype", "float64"]
    assert main(args + ["--output", str(tmp_path / "a"),
                        "--checkpoint-every", "100"]) == 0
    ck = os.path.join(str(tmp_path / "a"), "Raw", "4", "1", "checkpoint.npz")
    full = ["1", "4", "48", "1.0", "1.0", "5", "0.004", "4", "0", "0",
            "--quiet", "--dtype", "float64"]
    assert main(full + ["--output", str(tmp_path / "m"), "--mesh", "2,4",
                        "--resume", ck]) == 0
    assert main(full + ["--output", str(tmp_path / "s")]) == 0
    a = np.loadtxt(tmp_path / "m" / "Flux" / "1_4_48_1_1x5-flux.dat")
    b = np.loadtxt(tmp_path / "s" / "Flux" / "1_4_48_1_1x5-flux.dat")
    # resumed-mesh rows cover it >= 200 only; compare the overlap
    np.testing.assert_allclose(a[-3:], b[-3:], rtol=1e-9)


def test_cli_orbax_sharded_checkpoint_roundtrip(tmp_path):
    # Orbax sharded checkpointing end-to-end: a mesh run checkpoints with
    # --checkpoint-format orbax (each host writes its shards), then a mesh
    # run resumes from the directory (restore places arrays directly onto
    # the mesh) and reproduces the uninterrupted run's flux series.
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    args = ["1", "4", "48", "1.0", "1.0", "5", "0.002", "2", "0", "0",
            "--quiet", "--dtype", "float64", "--mesh", "2,4"]
    assert main(args + ["--output", str(tmp_path / "a"),
                        "--checkpoint-every", "100",
                        "--checkpoint-format", "orbax"]) == 0
    ck = str(tmp_path / "a" / "Raw" / "4" / "1" / "checkpoint_orbax")
    import os

    assert os.path.isdir(ck)
    full = ["1", "4", "48", "1.0", "1.0", "5", "0.004", "4", "0", "0",
            "--quiet", "--dtype", "float64"]
    assert main(full + ["--output", str(tmp_path / "m"), "--mesh", "2,4",
                        "--resume", ck]) == 0
    assert main(full + ["--output", str(tmp_path / "s")]) == 0
    a = np.loadtxt(tmp_path / "m" / "Flux" / "1_4_48_1_1x5-flux.dat")
    b = np.loadtxt(tmp_path / "s" / "Flux" / "1_4_48_1_1x5-flux.dat")
    np.testing.assert_allclose(a[-3:], b[-3:], rtol=1e-9)


def test_cli_orbax_cross_layout_resume(tmp_path):
    # cross-layout orbax resume: a SINGLE-DEVICE orbax checkpoint stores
    # the band-only force [2, band, X], while the jnp mesh layout carries
    # it full-size [2, Y, X] — load_orbax must adapt the layout instead
    # of failing the StandardRestore shape match
    import os

    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    args = ["1", "4", "48", "1.0", "1.0", "5", "0.002", "2", "0", "0",
            "--quiet", "--dtype", "float64"]
    assert main(args + ["--output", str(tmp_path / "a"),
                        "--checkpoint-every", "100",
                        "--checkpoint-format", "orbax"]) == 0
    ck = str(tmp_path / "a" / "Raw" / "4" / "1" / "checkpoint_orbax")
    assert os.path.isdir(ck)
    full = ["1", "4", "48", "1.0", "1.0", "5", "0.004", "4", "0", "0",
            "--quiet", "--dtype", "float64"]
    assert main(full + ["--output", str(tmp_path / "m"), "--mesh", "2,4",
                        "--resume", ck]) == 0
    assert main(full + ["--output", str(tmp_path / "s")]) == 0
    a = np.loadtxt(tmp_path / "m" / "Flux" / "1_4_48_1_1x5-flux.dat")
    b = np.loadtxt(tmp_path / "s" / "Flux" / "1_4_48_1_1x5-flux.dat")
    np.testing.assert_allclose(a[-3:], b[-3:], rtol=1e-9)


def test_cli_too_few_args():
    assert main(["1", "2", "3"]) == 1


def test_cli_domain_guard():
    # c_num=2, c_space=48 -> XDIM=96 < 2*LENGTH
    assert main(["1", "2", "48", "1.0", "1.0", "5", "1", "10", "0", "0"]) == 1


def test_cli_platform_gpu_without_gpu_fails(tmp_path, capsys):
    # asking for the GPU and finding none is an error, never a quiet CPU
    # run: no output is written
    import jax

    saved = jax.config.jax_platforms
    try:
        rc = main(["1", "4", "48", "1.0", "1.0", "5", "0.002", "2", "0",
                   "0", "--output", str(tmp_path), "--quiet",
                   "--platform", "gpu"])
    finally:
        jax.config.update("jax_platforms", saved)
    assert rc == 1
    assert "--platform gpu" in capsys.readouterr().err
    assert not (tmp_path / "Flux").exists()


@pytest.mark.parametrize("env,want_env", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, True),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, False),
    ({}, False),
])
def test_compile_cache_placement(env, want_env):
    # set: the environment's directory, and nothing chosen in code;
    # unset or empty: the fixed directory at the checkout's root
    import os

    from cuda_iblb_11_tpu.utils import compile_cache as cc

    path, from_env = cc.compile_cache_dir(env)
    assert from_env is want_env
    if want_env:
        assert path == "/elsewhere/cache"
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache") == cc.DEFAULT_DIR


@pytest.mark.parametrize("set_env", [True, False])
def test_configure_compile_cache_sets_jax_config(set_env, monkeypatch,
                                                 tmp_path):
    import jax

    from cuda_iblb_11_tpu.utils import compile_cache as cc

    saved = jax.config.jax_compilation_cache_dir
    if set_env:
        monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    else:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        got = cc.configure_compile_cache()
        if set_env:
            # jax reads the variable itself; code sets no other directory
            assert got == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir is None
        else:
            assert got == cc.DEFAULT_DIR
            assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def test_cli_overlap_flag_variants(tmp_path):
    """--overlap {auto,on,off} parses and lands in the SimLog resolved
    record; --no-overlap stays as a back-compat alias for --overlap off
    (the flag shipped first in r5 as a boolean)."""
    base = ["1", "4", "48", "1.0", "1.0", "5", "0.001", "2", "0", "1",
            "--quiet", "--snapshot-format", "npz"]
    for i, extra in enumerate((["--overlap", "on"], ["--no-overlap"])):
        out = tmp_path / str(i)
        assert main(base + ["--output", str(out)] + extra) == 0
        log = (out / "Raw" / "4" / "1" / "SimLog.txt").read_text()
        want = "on (requested)" if i == 0 else "off (requested)"
        assert f"Snapshot overlap: {want}" in log
