"""The PyTorch package, ``chip_smoke.py`` and ``tools/`` stand alone:
importing them loads neither ``jax`` nor the JAX package ``repro``, and no
source of theirs imports either."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py")))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))

BANNED = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))",
                    re.MULTILINE)


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_package_imports_without_jax_or_repro():
    code = (f"import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            f"print(len({MODULES!r}), bad)\n")
    n, bad = _run(code).strip().split(" ", 1)
    assert int(n) == len(MODULES) >= 15
    assert bad == "[]"


@pytest.mark.parametrize("module", ["repro_torch.models", "repro_torch.configs",
                                    "repro_torch.runtime",
                                    "repro_torch.launch.serve",
                                    "repro_torch.models.ssm",
                                    "repro_torch.kernels.linear_scan"])
def test_model_stack_imports_without_jax_or_repro(module):
    """The model stack alone (with every config file) loads neither."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "from repro_torch import configs\n"
            "for a in configs.all_archs(): configs.get(a)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))\n")
    assert _run(code).strip() == "[]"


@pytest.mark.parametrize("module", ["repro_torch.core.placement",
                                    "repro_torch.explore", "repro_torch.obs",
                                    "repro_torch.core.sensitivity",
                                    "repro_torch.sweep.scenarios"])
def test_engine_consumers_import_without_jax_or_repro(module):
    """Placement, the fault families and resilience, exploration and
    observability load neither, each alone and all together."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "import repro_torch.core.placement, repro_torch.explore, "
            "repro_torch.obs\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))\n")
    assert _run(code).strip() == "[]"


@pytest.mark.parametrize("module", [
    "repro_torch.launch.analysis", "repro_torch.examples.quickstart",
    "repro_torch.examples.latency_tolerance",
    "repro_torch.examples.sweep_study",
    "repro_torch.examples.collective_study",
    "repro_torch.examples.topology_study",
    "repro_torch.examples.explore_study"])
def test_service_and_examples_import_without_jax_or_repro(module):
    """The analysis service and each example flow load neither, alone."""
    code = (f"import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))\n")
    assert _run(code).strip() == "[]"


def test_chip_smoke_imports_without_jax_or_repro():
    """Loading ``chip_smoke.py`` (not running it) pulls in neither."""
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('chip_smoke', "
            "'chip_smoke.py')\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')))\n")
    assert _run(code).strip() == "[]"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_sources_import_neither(path):
    text = path.read_text()
    assert not BANNED.search(text), BANNED.search(text).group(0)
    assert "importlib.import_module(\"jax" not in text
