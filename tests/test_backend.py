"""Platform choice, kernel selection, compile cache, and the entry points
that must fail without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from rgbdslam.frontend.matcher import MatchResult
from rgbdslam.ops import backend
from rgbdslam.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,want", [("cpu", "xla"),
                                           ("gpu", "triton")])
def test_kernel_impl_table(platform, want):
    assert backend.kernel_impl("gicp", platform, size=1024) == want


@pytest.mark.parametrize("platform,size,want", [
    ("gpu", backend.KERNEL_MAX_SIZE["gicp"], "triton"),
    ("gpu", backend.KERNEL_MAX_SIZE["gicp"] + 1, "xla"),
    ("cpu", backend.KERNEL_MAX_SIZE["gicp"] + 1, "xla"),
])
def test_kernel_impl_size_bound(platform, size, want):
    """Above its measured size bound the one-CTA GICP kernel hands over to
    the XLA loop."""
    assert backend.kernel_impl("gicp", platform, size=size) == want


def test_kernel_impl_never_picks_interpret_mode():
    """Only compiled kernels or the plain reference: no table entry names
    the Pallas interpreter, on any platform."""
    impls = {impl for table in backend.KERNELS.values()
             for impl in table.values()}
    assert impls <= {"triton", "xla"}


@pytest.mark.parametrize("platform", ["rocm", "metal", "plugin"])
def test_kernel_impl_raises_on_unknown_platform(platform):
    with pytest.raises(RuntimeError, match="no kernel choice"):
        backend.kernel_impl("gicp", platform, size=1024)


def test_kernel_impl_follows_default_device():
    assert backend.current_platform() == "cpu"
    with jax.default_device(jax.devices("cpu")[0]):
        assert backend.kernel_impl("gicp", size=1024) == "xla"


def test_select_platform_gpu_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.select_platform("gpu")


def test_select_platform_rejects_unknown_name():
    with pytest.raises(ValueError):
        backend.select_platform("metal")


def test_cache_dir_env_set_wins():
    env = {compile_cache.ENV: "/somewhere/cache"}
    assert compile_cache.cache_dir("gpu", env) == "/somewhere/cache"
    assert compile_cache.cache_dir("cpu", env) == "/somewhere/cache"


def test_cache_dir_unset_is_checkout_cache():
    assert compile_cache.cache_dir("gpu", {}) == os.path.join(ROOT,
                                                              ".jax_cache")
    # XLA:CPU entries bake in host machine features
    assert compile_cache.cache_dir("cpu", {}) is None


def test_enable_compile_cache_leaves_env_setting_alone(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV, "/somewhere/cache")
    assert compile_cache.enable_compile_cache() == "/somewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_pytree_dataclass_replace_and_flatten():
    m = MatchResult(idx2=jnp.zeros(3, jnp.int32), dist=jnp.ones(3, jnp.int32),
                    valid=jnp.ones(3, bool))
    m2 = m.replace(valid=jnp.zeros(3, bool))
    assert not bool(m2.valid.any()) and bool(m.valid.all())
    assert len(jax.tree_util.tree_leaves(m2)) == 3
    doubled = jax.jit(lambda r: r.replace(dist=r.dist * 2))(m)
    assert doubled.dist.tolist() == [2, 2, 2]


def _run(argv, cwd=ROOT):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_platform_gpu_fails_without_gpu():
    out = _run(["-m", "rgbdslam.cli", "--dataset", "synthetic", "--frames",
                "2", "--platform", "gpu", "--out-dir", "/nonexistent/x"])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert out.stdout.strip() == ""


def test_chip_smoke_fails_without_gpu():
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _multihost_init_kwargs(monkeypatch, *args, **kw):
    from rgbdslam.parallel import multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **k: seen.update(k))
    multihost.initialize("localhost:1234", *args, **kw)
    return seen


@pytest.mark.parametrize("process_id", range(8))
def test_multihost_gpu_process_opens_only_its_card(monkeypatch, process_id):
    """2 hosts x 4 cards, one process per card: processes 0-3 on host 0 and
    4-7 on host 1 each open their host's local card process_id % 4."""
    seen = _multihost_init_kwargs(monkeypatch, 8, process_id,
                                  processes_per_host=4)
    assert seen["local_device_ids"] == [process_id % 4]
    assert seen["process_id"] == process_id and seen["num_processes"] == 8


@pytest.mark.parametrize("process_id", [0, 1])
def test_multihost_one_process_per_host_keeps_all_cards(monkeypatch,
                                                        process_id):
    """2 hosts, one process each: no card restriction, so each process opens
    every card of its host and the global mesh keeps them all."""
    seen = _multihost_init_kwargs(monkeypatch, 2, process_id)
    assert seen["local_device_ids"] is None


def test_multihost_rejects_zero_processes_per_host():
    from rgbdslam.parallel import multihost

    with pytest.raises(ValueError):
        multihost.local_card_ids(0, 0)
