"""What the benchmark loads: no run holds JAX or the JAX package, the
reference holds nothing of the port, and run.py fails loudly without a
card."""

import ast
import os
import subprocess
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = {"jax", "jaxlib", "flax", "cube_slam_tpu"}


def _modules(code):
    """Top-level names of the modules a fresh interpreter holds after `code`."""
    probe = code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def _all_modules():
    for sub in ("", "metrics", "checks", "reference", "traffic", "entries", "tools"):
        d = os.path.join(BENCH_DIR, sub)
        for f in sorted(os.listdir(d)):
            if f.endswith(".py") and not f.startswith("__"):
                yield ".".join(p for p in ("portbench", sub, f[:-3]) if p)


def test_nothing_loads_jax_or_the_jax_package():
    code = "\n".join(f"import {m}" for m in _all_modules())
    code += "\nfrom portbench import drive\ndrive.port_modules()"
    held = _modules(code)
    assert "cube_slam_tpu_torch" in held
    assert not held & FORBIDDEN, held & FORBIDDEN


def test_the_reference_holds_nothing_of_the_port():
    refs = [m for m in _all_modules() if m.startswith("portbench.reference.")]
    held = _modules("\n".join(f"import {m}" for m in refs))
    assert not held & (FORBIDDEN | {"cube_slam_tpu_torch"})
    for m in refs:
        path = os.path.join(ROOT, *m.split(".")) + ".py"
        tree = ast.parse(open(path).read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert not any(x.split(".")[0] in FORBIDDEN | {"cube_slam_tpu_torch"} for x in names), (m, names)


def test_run_fails_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "kitti_mono.objects", "--seed",
                          "2147483659", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_fails_in_a_checkout_without_the_port(tmp_path):
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "kitti_mono.objects", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
