"""The PyTorch port stands alone: importing every module of ccsmeth_tpu_torch
pulls in no jax, no triton and no module of the JAX package."""

import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ccsmeth_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import ccsmeth_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ccsmeth_tpu_torch.__path__,
                                               "ccsmeth_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton")
             or m.split(".")[0].startswith("jax")
             or m == "ccsmeth_tpu" or m.startswith("ccsmeth_tpu."))
print(len(names))
print("BAD", bad)
"""


def test_port_imports_no_jax_triton_or_jax_package():
    # a fresh interpreter without tests/conftest.py (which imports jax)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert int(lines[-2]) >= 49  # every module of the package was imported
    assert lines[-1] == "BAD []", lines[-1]


def test_port_sources_never_import_jax_or_the_jax_package():
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                text = fh.read()
            # the package imports itself relatively, so even its own name
            # never follows "from" or "import"
            for needle in ("import jax", "from jax", "from ccsmeth_tpu",
                           "import ccsmeth_tpu", "import triton"):
                if needle in text:
                    offenders.append((os.path.relpath(path, REPO), needle))
    assert not offenders, offenders


# the port's copies of the JAX package's host modules: the same text, with
# paths into the reference checkout written relative to it
COPIES = ["utils/constants", "utils/codecs", "utils/logging", "utils/fasta",
          "utils/process", "utils/simulate", "bamio/bgzf", "bamio/bam",
          "bamio/bai", "bamio/native", "features/extract", "features/batch",
          "features/mp_extract", "pipeline/modbam", "models/config",
          "models/params_io", "training/data", "bamio/tabix",
          "pipeline/call_freq_txt", "pipeline/extract", "wrappers/__init__",
          "wrappers/call_hifi", "wrappers/align_hifi"]


@pytest.mark.parametrize("module", COPIES)
def test_copied_module_equals_the_jax_package_module(module):
    def text(pkg):
        with open(os.path.join(REPO, pkg, module + ".py")) as fh:
            return re.sub(r"/\w+/reference/", "", fh.read())

    assert text("ccsmeth_tpu_torch") == text("ccsmeth_tpu")


@pytest.mark.parametrize("module", ["ops.bigru", "ops.bigru_vjp", "models.attrnn",
                                    "training.train", "cli", "ops.bilstm_vjp",
                                    "ops.kernel_args", "ops.transenc",
                                    "models.transenc", "pipeline.call_freq_bam",
                                    "pipeline.call_mods", "training.aggregate",
                                    "scripts.train_aggregate_model",
                                    "wrappers.call_hifi", "wrappers.align_hifi"])
def test_module_imports_first_in_a_fresh_interpreter(module):
    """No import cycle: each entry module imports on its own, first, and
    brings in no jax."""
    env = dict(os.environ, PYTHONPATH=REPO)
    probe = ("import sys, ccsmeth_tpu_torch.{}\n"
             "assert not [m for m in sys.modules if m.split('.')[0].startswith('jax')]"
             .format(module))
    proc = subprocess.run(
        [sys.executable, "-c", probe],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_every_cpu_test_file_caps_torch_threads():
    """Tier-1 runs the suite in several xdist workers on one machine, each
    with torch's default of one intra-op thread a core: every port test file
    that runs torch on the CPU (all but the card's *_cuda.py) sets
    ``torch.set_num_threads(1)`` at module level, where collection runs it."""
    import ast
    import glob

    missing = []
    for path in sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py"))):
        if path.endswith("_cuda.py"):
            continue
        with open(path) as fh:
            tree = ast.parse(fh.read())
        capped = any(
            isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
            and ast.unparse(node.value) == "torch.set_num_threads(1)"
            for node in tree.body)
        if not capped:
            missing.append(os.path.basename(path))
    assert not missing, missing
