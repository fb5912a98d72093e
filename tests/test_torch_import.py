"""The port stands alone: importing every module of ``repro_torch``, the
GPU check ``chip_smoke.py`` and its A/B timer ``kernel_ab.py`` loads
neither JAX nor anything of the JAX package ``repro``."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke, kernel_ab
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro")
             or m.startswith(("jax.", "jaxlib.", "repro.")))
print(len(names), bad)
print(" ".join(names))
sys.exit(1 if bad else 0)
"""

# modules the probe must reach by name (the mesh modules among them)
NAMED = ("repro_torch.parallel", "repro_torch.parallel.sharding",
         "repro_torch.launch.mesh", "repro_torch.device",
         "repro_torch.kernels.lut_gather.ops", "repro_torch.data.loader")


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", PROBE, ROOT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 67, proc.stdout
    names = set(proc.stdout.splitlines()[1].split())
    assert set(NAMED) <= names, sorted(set(NAMED) - names)


WORKER_PROBE = """
import runpy, sys
sys.argv = ["repro_torch.launch.worker", "--help"]
try:
    runpy.run_module("repro_torch.launch.worker", run_name="__main__")
except SystemExit as e:
    if e.code != 0:
        raise
import repro_torch.launch.fleet, repro_torch.launch.transport
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro")
             or m.startswith(("jax.", "jaxlib.", "repro.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_fleet_modules_and_worker_cli_import_no_jax():
    """The fleet's three modules, and a worker started as its own
    program (``python -m repro_torch.launch.worker``, here with
    ``--help``), load neither JAX nor anything of ``repro``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", WORKER_PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "usage: repro_torch.launch.worker" in proc.stdout
    assert proc.stdout.strip().endswith("[]"), proc.stdout


SERVE_PROBE = """
import runpy, sys
sys.argv = ["repro_torch.launch.serve", "--lut", "--help"]
try:
    runpy.run_module("repro_torch.launch.serve", run_name="__main__")
except SystemExit as e:
    if e.code != 0:
        raise
import repro_torch.core.lut_synth, repro_torch.core.lutdnn
import repro_torch.core.poly, repro_torch.data, repro_torch.optim
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro")
             or m.startswith(("jax.", "jaxlib.", "repro.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_train_synth_modules_and_serve_lut_cli_import_no_jax():
    """The training and synthesis modules (``core.poly``, ``core.lutdnn``,
    ``core.lut_synth``, ``optim``, ``data``), and the LUT serving CLI
    started as its own program (``python -m repro_torch.launch.serve
    --lut --help``), load neither JAX nor anything of ``repro``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", SERVE_PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "--save-artifact" in proc.stdout
    assert proc.stdout.strip().endswith("[]"), proc.stdout


SEARCH_PROBE = """
import sys
import repro_torch.core.masking, repro_torch.core.sparse_train
from repro_torch.core import (ThetaLayer, init_theta_layer, random_mask,
                              mask_to_indices, final_mask, effective_weight,
                              SparsityConfig, sparse_control,
                              make_search_step, search_connectivity,
                              masks_to_conn)
from repro_torch.core.lutdnn import (search_connectivity_population,
                                     search_state_from_numpy)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro")
             or m.startswith(("jax.", "jaxlib.", "repro.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_search_modules_and_core_exports_import_no_jax():
    """The connectivity search (``core.masking``, ``core.sparse_train``
    and the search half of ``core.lutdnn``) and the names ``core``
    exports, as the reference's ``repro.core`` does, load neither JAX
    nor anything of ``repro``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", SEARCH_PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("[]"), proc.stdout


LM_PROBE = """
import importlib, runpy, sys
sys.path.insert(0, sys.argv[1])
for name in ("torch_quickstart", "torch_mnist_sparselut", "torch_lut_serve",
             "torch_lm_sparse_train"):
    importlib.import_module(name)
for mod in ("repro_torch.launch.train", "repro_torch.launch.serve"):
    sys.argv = [mod, "--help"]
    try:
        runpy.run_module(mod, run_name="__main__")
    except SystemExit as e:
        if e.code != 0:
            raise
import repro_torch.models.layers, repro_torch.models.lm
import repro_torch.models.registry, repro_torch.optim.schedules
import repro_torch.models.encdec, repro_torch.models.recurrent
from repro_torch.models import registry
for arch in registry.ARCHS:
    registry.get_config(arch)
import repro_torch.data.tokens, repro_torch.checkpoint.checkpoint
import repro_torch.runtime.trainer, repro_torch.runtime.straggler
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro")
             or m.startswith(("jax.", "jaxlib.", "repro.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_lm_modules_train_cli_and_examples_import_no_jax():
    """The LMs (attention, MoE, RG-LRU, RWKV) and the encoder-decoder, the
    config of every registered architecture, their training
    (``models``, ``optim.schedules``, ``data.tokens``, ``checkpoint``,
    ``runtime``), the train and serve CLIs started as their own programs
    (``--help``) and the four ``examples/torch_*.py`` load neither JAX
    nor anything of ``repro``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", LM_PROBE,
                           os.path.join(ROOT, "examples")], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "--sparse-ffn" in proc.stdout and "--kv-int8" in proc.stdout
    assert proc.stdout.strip().endswith("[]"), proc.stdout
