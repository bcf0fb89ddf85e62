"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or rule_guided_music_tpu (compared whole: the port's name begins with the
JAX package's), and a reference that imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "rule_guided_music_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=BENCH.parent, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0", "PYTHONPATH": f"{BENCH}:{BENCH.parent}"})
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_drivers_load_no_jax():
    code = ("import harness.common, harness.trace, harness.weights, harness.readers\n"
            "from harness import common\n"
            "for n in ('sample_chain', 'train_step'):\n"
            "    common.load_module(common.BENCH_DIR / 'drivers' / f'{n}.py')\n"
            "for p in (common.BENCH_DIR / 'metrics').glob('*.py'):\n"
            "    common.load_module(p)\n"
            "import rule_guided_music_tpu_torch.pipeline, rule_guided_music_tpu_torch.training.train_loop\n"
            "import rule_guided_music_tpu_torch.train_dit")
    loaded = loaded_after(code)
    assert "rule_guided_music_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    code = "import reference.models, reference.rules, reference.diffusion, " \
           "reference.sample_check, reference.train_check"
    loaded = loaded_after(code)
    assert not loaded & (FORBIDDEN | {"rule_guided_music_tpu_torch"})
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "typing", "__future__", "math"}, (path, n)
