"""The package's former name stays importable as an alias of rgbdslam."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

import rgbdslam.slam.system
from rgbdslam import _alias

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def alias():
    name = "rgbdslam_formername"
    finder = _alias.install(name)
    yield name
    sys.meta_path.remove(finder)
    for mod in [m for m in sys.modules if m.split(".")[0] == name]:
        del sys.modules[mod]


def test_alias_submodule_is_the_real_module(alias):
    m = importlib.import_module(f"{alias}.slam.system")
    assert m is rgbdslam.slam.system
    # the shared module keeps its own spec
    assert m.__spec__.name == "rgbdslam.slam.system"


def test_alias_unknown_submodule_raises(alias):
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(f"{alias}.no_such_module")


def _alias_packages():
    return [p.parent.name for p in ROOT.glob("*/__init__.py")
            if "install(__name__)" in p.read_text()]


def test_repo_ships_an_alias_package():
    assert len(_alias_packages()) == 1


@pytest.mark.parametrize("pkg", _alias_packages())
def test_alias_runs_the_cli(pkg):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-m", f"{pkg}.cli", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--dataset" in out.stdout
