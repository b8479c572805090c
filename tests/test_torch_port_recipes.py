"""The pre-port recipes' copies for the port (`scripts/torch/*.sh`): each is
run by the shell with a stand-in `python` first on the PATH that records
the arguments it gets (`"$@"` empty, the environment's defaults filled in),
and those arguments go through the port's own argument parser of the
command (or of `scripts/learning_proof_cuda.py`). A recipe that names a
flag the port lacks fails here. Each copy passes the flags of its original
(`scripts/*.sh`, which drive the JAX package) and drives the port, and no
comment carries a TPU number."""
import importlib.util
import json
import os
import re
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ("extract_hist_embs.sh", "run_eta0.1.sh", "run_eval_fitb.sh", "run_eval_gor.sh",
           "run_eval_grounding.sh", "run_inf4eval.sh", "run_learning_proof.sh",
           "run_serve_fast.sh")
ENV_DEFAULTS = ("DATA_PATH", "OUTPUT_DIR", "PRETRAINED_DIR", "GEN_DIR", "EVAL_WEIGHTS",
                "CKPT_DIR", "PORT", "IMG_FOLDER", "IMAGE_PATHS", "WORKDIR", "STEPS", "IMG",
                "INFERENCE_STEPS")
STUB = """#!/bin/sh
{python} -c 'import json, sys; json.dump(sys.argv[1:], open("{out}", "w"))' "$@"
"""


def _argv(script, tmp_path):
    """The arguments `python` gets from the recipe at `script`."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    out = tmp_path / "argv.json"
    stub = bindir / "python"
    stub.write_text(STUB.format(python=subprocess.check_output(
        ["sh", "-c", "command -v python3"], text=True).strip(), out=out))
    stub.chmod(0o755)
    env = {k: v for k, v in os.environ.items() if k not in ENV_DEFAULTS}
    env["PATH"] = f"{bindir}:{env['PATH']}"
    shell = "bash" if open(script).readline().rstrip().endswith("bash") else "sh"
    subprocess.run([shell, script], cwd=tmp_path, env=env, check=True, timeout=60)
    return json.loads(out.read_text())


def _port_parser(argv):
    """(the port's parse_args for the command, its arguments)."""
    if argv[:2] == ["-m", "difashion_tpu_torch"]:
        from difashion_tpu_torch.cli import evaluate, extract_features, generate, serve, train

        parsers = {"train": train, "generate": generate, "evaluate": evaluate,
                   "serve": serve, "extract-features": extract_features}
        return parsers[argv[2]].parse_args, argv[3:]
    assert argv[0] == "scripts/learning_proof_cuda.py", argv
    spec = importlib.util.spec_from_file_location(
        "learning_proof_cuda", os.path.join(REPO, argv[0]))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.parse_args, argv[1:]


def _flags(argv):
    return sorted(a for a in argv if a.startswith("--"))


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_parses_with_the_ports_parser(name, tmp_path):
    argv = _argv(os.path.join(REPO, "scripts", "torch", name), tmp_path)
    parse, args = _port_parser(argv)
    parse(args)                                 # an unknown flag exits here
    original = _argv(os.path.join(REPO, "scripts", name), tmp_path)
    if name == "run_learning_proof.sh":
        # the JAX proof's flags less its default work directory
        assert original[0] == "tools/learning_proof_tpu.py"
        assert _flags(args) == [f for f in _flags(original) if f != "--workdir"]
    else:
        assert original[:3] == ["-m", "difashion_tpu", argv[2]]
        assert _flags(args) == _flags(original[3:])


def test_every_original_recipe_has_a_copy_without_tpu_numbers():
    originals = sorted(f for f in os.listdir(os.path.join(REPO, "scripts")) if f.endswith(".sh"))
    assert originals == sorted(RECIPES)
    assert sorted(os.listdir(os.path.join(REPO, "scripts", "torch"))) == sorted(RECIPES)
    for name in RECIPES:
        text = open(os.path.join(REPO, "scripts", "torch", name)).read()
        comments = " ".join(line for line in text.splitlines() if line.startswith("#"))
        assert "TPU" not in comments and "difashion_tpu " not in text, name
        assert not re.search(r"\d+(\.\d+)?\s*(vs|outfit-img|img/s)", comments), name
