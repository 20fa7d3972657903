"""What the harness loads: neither JAX nor the JAX package (top-level names
compared whole, since the port's name begins with the JAX package's), and a
reference that imports nothing of the program."""
import ast
import subprocess
import sys

from h100bench.core import bench

CLOSURE = r"""
import sys
sys.argv = ["run.py"]
sys.path.insert(0, {root!r})
import runpy
runpy.run_path({run!r}, run_name="not_main")
from h100bench.core import bench
m = bench.load_manifest()
for c in m["configs"]:
    kind = bench.data("configs", c["name"])["kind"]
    bench.kind_module(kind)
    bench.reference_module(kind)
for x in m["per_layer"]:
    bench.metric_reader(x["name"])
import seed_tpu_torch.models.llama, seed_tpu_torch.serving.scheduler
import seed_tpu_torch.models.seed_tokenizer, seed_tpu_torch.ops.preprocess
print(sorted({{k.split(".")[0] for k in sys.modules}}))
print(bench.forbidden_modules())
"""


def test_run_closure_free_of_jax_and_seed_tpu():
    code = CLOSURE.format(root=str(bench.ROOT),
                          run=str(bench.BENCH / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=bench.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, bad = out.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    for name in ("jax", "jaxlib", "flax", "seed_tpu"):
        assert f"'{name}'" not in loaded
    assert "'seed_tpu_torch'" in loaded


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "seed_tpu_torch_fake", object())
    assert "seed_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "seed_tpu.fake", object())
    assert bench.forbidden_modules() == ["seed_tpu"]


def test_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "typing", "__future__", "math"}
    for path in (bench.BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
