"""Tests of the GPU bring-up: the platform decision, the compile-cache
placement, the jit that hoists set-up arrays, the smoke script's refusal
without a GPU, the in-repo flagship param file through the CLI, and the
chemistry dt limit's wind-cell exclusion."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pion_tpu import device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_platform_helper_refuses_cpu():
    assert jax.default_backend() == "cpu"
    assert not device.on_gpu()
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


def test_compile_cache_leaves_env_choice_alone(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert device.compile_cache_dir() is None
    assert device.use_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert device.compile_cache_dir() == want
    assert device.use_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_flagship_params_run_on_cpu(tmp_path):
    """params/ostar3d_class_coupled.txt through icgen + run at 16^3 per
    level (wind region kept at 6 fine cells): finite fields, a carved
    wind cavity and ionization beyond the wind region."""
    from pion_tpu.cli import icgen_main, run_main
    from pion_tpu.constants import RO, VX

    pf = os.path.join(ROOT, "params", "ostar3d_class_coupled.txt")
    ov = ["NGridX=16", "NGridY=16", "NGridZ=16", "WIND_0_radius=1.125e18",
          f"OutputPath={tmp_path}/"]
    snap = icgen_main([pf] + ov)
    sim = run_main([snap, "max_steps=2"])
    assert sim.step_count == 2 and sim.t > 0.0
    assert sim.physics.sources[0].effect == "mfion"
    levels = [np.asarray(p) for p in sim.P]
    assert all(np.all(np.isfinite(P)) for P in levels)
    assert levels[0].dtype == np.float64
    cfg = sim.cfgs[1]
    wind = sim.physics.wind_sources[0]
    ax = [np.asarray(cfg.cell_centers(a)) - wind.position[a]
          for a in range(3)]
    Z, Y, X = np.meshgrid(*ax, indexing="ij")
    r = np.sqrt(X * X + Y * Y + Z * Z)
    xion = levels[1][cfg.eqn.nbase]
    # ambient x(H+) is 1e-6; the I-front cells past the wind region rise
    assert xion[r > wind.radius + cfg.dx].max() > 1.0e-5
    iz, iy = np.argmin(np.abs(ax[0])), np.argmin(np.abs(ax[1]))
    ix = np.argmin(np.abs(ax[2] - 4.5 * cfg.dx))
    assert levels[1][RO][iz, iy, ix] < 0.1 * levels[0][RO].max()
    assert levels[1][VX][iz, iy, ix] > 0.5 * wind.vinf


def _hoist_case():
    w = jnp.asarray(np.linspace(0.0, 1.0, 64 * 64, dtype=np.float32)
                    .reshape(64, 64))        # 16 KB: above the threshold

    def f(x, scale=2.0, extra=None):
        y = x * w * scale
        if extra is not None:
            y = y + extra["b"]
        return {"y": y, "s": jnp.sum(y)}

    return w, f


@pytest.mark.parametrize("kw", [{}, {"scale": 3.0},
                                {"extra": {"b": np.float32(1.5)}}])
def test_hoisted_jit_matches_jit(kw):
    """Same results as jax.jit for defaults, keywords and pytrees."""
    _w, f = _hoist_case()
    x = jnp.ones((64, 64), jnp.float32)
    got = device.HoistedJit(f)(x, **kw)
    want = jax.jit(f)(x, **kw)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_hoisted_jit_passes_closed_over_arrays_as_arguments():
    """The closed-over 64x64 array is a parameter of the compiled program;
    under plain jax.jit it is a literal constant."""
    _w, f = _hoist_case()
    x = jnp.ones((64, 64), jnp.float32)

    def big_constants(text):
        return [ln for ln in text.splitlines()
                if "constant" in ln and "tensor<64x64xf32>" in ln]

    text = device.HoistedJit(f).lower(x).as_text()
    assert big_constants(jax.jit(f).lower(x).as_text())
    assert not big_constants(text)
    main = next(ln for ln in text.splitlines() if "func.func public @main"
                in ln)
    assert main.count("tensor<64x64xf32>") >= 3   # w, x and the output


def test_hoisted_jit_one_program_per_signature():
    _w, f = _hoist_case()
    hj = device.HoistedJit(f)
    hj(jnp.ones((64, 64), jnp.float32))
    hj(jnp.zeros((64, 64), jnp.float32), 4.0)
    assert len(hj._programs) == 1
    hj(jnp.ones((64, 64), jnp.float64 if jax.config.read("jax_enable_x64")
                else jnp.int32))
    assert len(hj._programs) == 2


def test_hoisted_jit_replicates_arrays_over_a_mesh():
    """With sharded inputs the hoisted arrays are replicated over the same
    mesh, and the result matches the unsharded one."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("a", "b"))
    w, f = _hoist_case()
    x = jax.device_put(jnp.ones((64, 64), jnp.float32),
                       NamedSharding(mesh, PartitionSpec("a", "b")))
    hj = device.HoistedJit(f)
    got = hj(x)
    (_fn, hoisted, _tree), = hj._programs.values()
    assert [len(h.sharding.device_set) for h in hoisted] == [4]
    np.testing.assert_allclose(np.asarray(got["y"]),
                               np.asarray(f(np.ones((64, 64)))["y"]),
                               rtol=1e-6)


def test_chemistry_dt_skips_wind_cells(tmp_path):
    """The chemistry dt limit is the smallest cell timescale outside the
    wind region (boundary data, like the CFL limit); wind cells with
    shorter timescales do not set it."""
    from pion_tpu.cli import icgen_main, run_main
    from pion_tpu.constants import PG

    pf = os.path.join(ROOT, "params", "ostar3d_class_coupled.txt")
    ov = ["NGridX=16", "NGridY=16", "NGridZ=16", "WIND_0_radius=1.125e18",
          f"OutputPath={tmp_path}/"]
    sim = run_main([icgen_main([pf] + ov), "max_steps=1"])
    lev = 1
    ph, cfg, P = sim.phys[lev], sim.cfgs[lev], sim.P[lev]
    mask = np.asarray(ph.wind_exclude_mask())
    assert mask.any() and not mask.all()
    # a near-zero pressure in the wind cells shortens their timescales
    P = P.at[PG].set(jnp.where(mask, 1.0e-30, P[PG]))
    rt = ph.raytrace(P)
    t = np.asarray(ph.mp.cell_timescales(P, cfg, rt))
    assert t[mask].min() < 0.5 * t[~mask].min()
    np.testing.assert_allclose(float(ph.timescale(P, cfg)), t[~mask].min(),
                               rtol=1e-12)
