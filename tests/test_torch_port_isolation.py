"""The PyTorch port stands alone: no module of `difashion_tpu_torch`, and not
`chip_smoke.py` or a script of `scripts/`, imports JAX, flax, msgpack,
ml_dtypes or the JAX package (the card's machine has none of them)."""
import ast
import os
import pkgutil
import subprocess
import sys

import difashion_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "difashion_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "difashion_tpu")
# packages the card's machine does not have: the port reads safetensors and
# flax msgpack files itself
PACKAGES = ("safetensors", "msgpack", "ml_dtypes")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        difashion_tpu_torch.__path__, "difashion_tpu_torch."))


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    scripts = os.path.join(REPO, "scripts")
    for f in sorted(os.listdir(scripts)):
        if f.endswith(".py"):
            yield os.path.join(scripts, f)


def test_port_imports_no_jax_in_a_fresh_interpreter():
    mods = _modules()
    for mod in ("engine.generate", "engine.train", "engine.optim8bit", "engine.pipeline",
                "nn.kernels.flash_attention", "nn.kernels.groupnorm",
                "nn.kernels.skinny_matmul", "diffusion.ddim", "diffusion.dpmpp",
                "checkpoint", "data.datasets", "data.prompts", "data.tokenizer",
                "data.preprocessing", "data.precompute", "cli.common", "cli.extract_features",
                "cli.generate", "cli.serve", "cli.train", "cli.info", "core.logging",
                "core.tensorboard", "core.importer", "engine.memory", "__main__",
                "core.msgpack", "core.flax_layout", "data.native", "eval", "eval.metrics",
                "eval.extractors", "eval.drivers", "eval.models.open_clip_vit",
                "eval.models.inception", "eval.models.lpips", "eval.models.compat"):
        assert f"difashion_tpu_torch.{mod}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + PACKAGES!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_port_sources_have_no_forbidden_imports():
    offenders = []
    sources = list(_sources())
    # every source of every subpackage is scanned, the core/ package's too
    for sub in ("core", "cli", "engine", "data", "nn", "models", "diffusion", "eval"):
        assert any(os.sep + sub + os.sep in p for p in sources), sub
    forbidden = FORBIDDEN + PACKAGES
    for path in sources:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in forbidden:
                    offenders.append(f"{path}:{node.lineno} {name}")
    assert not offenders, offenders
