"""The port imports torch and never jax (nor the JAX package); its kernel modules build nothing
at import; `chip_smoke.py` refuses to run without a CUDA device."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "sam_pt_torch.build",
    "sam_pt_torch.ops.flash_attention",
    "sam_pt_torch.ops._cuda",
    "sam_pt_torch.ops.posemb",
    "sam_pt_torch.ops.resize",
    "sam_pt_torch.ops.sampling",
    "sam_pt_torch.models.sam.image_encoder",
    "sam_pt_torch.models.sam.prompt_encoder",
    "sam_pt_torch.models.sam.mask_decoder",
    "sam_pt_torch.models.sam.sam_model",
    "sam_pt_torch.models.sam.predictor",
    "sam_pt_torch.models.sam.factory",
    "sam_pt_torch.models.tracker",
    "sam_pt_torch.models.tracker.api",
    "sam_pt_torch.models.tracker.pips.model",
    "sam_pt_torch.models.tracker.pips.tracker",
    "sam_pt_torch.models.tracker.pips2.model",
    "sam_pt_torch.models.tracker.pips2.tracker",
    "sam_pt_torch.models.tracker.raft.model",
    "sam_pt_torch.models.tracker.raft.tracker",
    "sam_pt_torch.models.tracker.cotracker.model",
    "sam_pt_torch.models.tracker.cotracker.tracker",
    "sam_pt_torch.models.sam_pt",
    "sam_pt_torch.utils.checkpoint",
    "sam_pt_torch.utils.query_points",
    "sam_pt_torch.utils.util",
    "sam_pt_torch.vos_eval.eval",
]


def _run(code: str, cwd: str = ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert 'flax' not in sys.modules, 'flax was imported'\n"
            "assert 'sam_pt_tpu' not in sys.modules, 'JAX package imported'\n"
            "import sam_pt_torch.ops._cuda as c\n"
            "assert c._LIB is None, 'kernels built at import'\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_calls_no_library_attention():
    """`scaled_dot_product_attention` is only `chip_smoke.py`'s yardstick:
    no source of the port names it."""
    pkg = os.path.join(ROOT, "sam_pt_torch")
    found = []
    for folder, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(folder, name)
                with open(path, encoding="utf-8") as f:
                    if "scaled_dot_product_attention" in f.read():
                        found.append(os.path.relpath(path, ROOT))
    assert found == []


def test_chip_smoke_needs_a_card():
    proc = _run("import runpy; runpy.run_path('chip_smoke.py', "
                "run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
