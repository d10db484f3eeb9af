"""The port stands alone: importing ``repro_torch`` (every submodule and
subpackage) loads no jax, no ``ml_dtypes``, nothing of ``repro`` and
nothing of the reference's top-level ``benchmarks`` package, and no port
file nor ``chip_smoke.py`` imports them."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    "repro_torch." + ".".join(
        (p.parent if p.name == "__init__.py" else p.with_suffix(""))
        .relative_to(PORT).parts)
    for p in PORT.rglob("*.py") if p.parent != PORT or p.name != "__init__.py"
)


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                roots.add(node.module.split(".")[0])
    return roots


def test_port_has_the_slice_modules():
    for name in ("events.synthetic", "events.stream", "core.hwmodel",
                 "core.pr_eval", "core.prng", "core.dvfs", "core.stcf",
                 "core.tos", "core.ber", "core.harris", "core.state",
                 "core.pipeline", "kernels._build", "kernels.fused_step",
                 "kernels.harris_conv", "kernels.ops", "kernels.compact",
                 "kernels.tos_update", "kernels.ber_draw",
                 "obs.metrics", "obs.sinks", "obs.schema", "obs.d2h",
                 "launch.sharding", "serve.streaming", "serve.scheduler",
                 "serve.runtime", "serve.pool", "launch.serve_events",
                 "examples.quickstart", "benchmarks.bench_streaming",
                 "benchmarks.scenarios", "benchmarks.run",
                 "events.datasets", "examples.corner_detection_e2e",
                 "benchmarks.bench_hwmodel", "benchmarks.bench_dvfs",
                 "benchmarks.bench_auc", "benchmarks.bench_throughput",
                 "benchmarks.bench_tos_kernels", "benchmarks.bounds",
                 "benchmarks.timing", "core.baselines", "events.aer",
                 "configs", "configs.qwen2_0_5b", "configs.deepseek_v3_671b",
                 "models.common", "models.attention", "models.mlp",
                 "models.ssm", "models.transformer", "train.train_step",
                 "launch.serve", "train.optimizer", "train.compression",
                 "train.checkpoint", "train.fault_tolerance",
                 "launch.train", "compat", "meshctx", "launch.mesh",
                 "examples.serve_lm", "examples.train_lm", "utils",
                 "utils.hlo_analysis", "launch.roofline", "launch.dryrun",
                 "benchmarks.roofline_table"):
        assert "repro_torch." + name in MODULES
    for src in ("fused_step", "harris", "compact", "tos_update", "tos_count",
                "ber_draw"):
        assert (PORT / "csrc" / f"{src}.cu").is_file()


def test_import_loads_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {['repro_torch', *MODULES]!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                    'benchmarks', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_reference_imports(path):
    assert not _imported_roots(path) & {"repro", "jax", "jaxlib",
                                        "benchmarks", "ml_dtypes"}
