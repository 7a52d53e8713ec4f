"""The port's quickstart walk-throughs (``docs_torch/``) are executed, not
trusted, as the JAX package's are (tests/test_quickstart_docs.py): every
```bash block of each document runs verbatim, in order, in one shell,
with ``DEVICE=cpu`` so that ``pio train``/``deploy``/``eval`` run on the
CPU (the ALS walk-throughs here; classification, evaluation and
sessionrec in tests/test_torch_quickstart_docs_eval_seq.py, so that the
test runner can run the two halves side by side). A second test holds
each of the six documents against its ``docs/`` twin: the same bash
blocks step for step and the same ``engine.json`` parameters, PATH, the
device, the factory names and the ports apart.

The ports of the walk-throughs are the JAX documents' moved into the
27xxx-29xxx range, so that both sets can run at the same time (the
test runner spreads files over worker processes).
"""

from __future__ import annotations

import json
import os
import re
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOCS = (
    "quickstart-recommendation.md",
    "quickstart-classification.md",
    "quickstart-similarproduct.md",
    "quickstart-ecommerce.md",
    "quickstart-evaluation.md",
    "quickstart-sessionrec.md",
)
#: the walk-throughs this file runs
ALS_DOCS = ("quickstart-recommendation.md", "quickstart-similarproduct.md",
            "quickstart-ecommerce.md")


def _bash_blocks(text: str) -> list[str]:
    return re.findall(r"```bash\n(.*?)```", text, re.S)


def _read(folder: str, doc: str) -> str:
    with open(os.path.join(REPO, folder, doc)) as f:
        return f.read()


def _engine_json(blocks: list[str]) -> dict | None:
    for block in blocks:
        found = re.search(r"cat > engine\.json <<'EOF'\n(.*?)\nEOF", block, re.S)
        if found:
            return json.loads(found.group(1))
    return None


def run_walkthrough(doc: str, env: dict, cwd: str, timeout: float = 900):
    """The document's blocks in one bash under the JAX test's preamble
    (strict mode, background jobs killed on exit)."""
    script = (
        "set -euo pipefail\n"
        "trap 'kill $(jobs -p) 2>/dev/null || true' EXIT\n"
        + "\n".join(_bash_blocks(_read("docs_torch", doc)))
    )
    return subprocess.run(["bash", "-c", script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def check_runs_verbatim(doc: str) -> None:
    assert len(_bash_blocks(_read("docs_torch", doc))) >= 4, f"{doc}: expected a full walk-through"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_") and k not in ("PIO_FS_BASEDIR", "PIO_MODEL_DIR")}
    env["DEVICE"] = "cpu"
    # one retry, as the JAX test allows: fixed ports and readiness
    # windows on a loaded host
    for _attempt in (1, 2):
        out = run_walkthrough(doc, env, REPO)
        if out.returncode == 0:
            break
    assert out.returncode == 0, (
        f"{doc} failed twice (rc={out.returncode})\n--- stdout:\n"
        f"{out.stdout[-4000:]}\n--- stderr:\n{out.stderr[-4000:]}"
    )


@pytest.mark.parametrize("doc", ALS_DOCS)
def test_torch_quickstart_doc_runs_verbatim(doc):
    check_runs_verbatim(doc)


#: the port documents' ports, by the JAX documents' ports
PORTS = {7172: 27172, 7173: 27173, 7174: 27174, 7175: 27175, 17178: 27178, 17180: 27180,
         18202: 28202, 18203: 28203, 18204: 28204, 18205: 28205, 18211: 28211, 19178: 29178}


def _as_jax(block: str) -> str:
    """A port block with what may differ mapped back onto the JAX
    document's text: PATH, the device, the factory names and the ports."""
    block = block.replace('export PATH="$PWD/bin_torch:$PATH"', 'export PATH="$PWD/bin:$PATH"')
    block = re.sub(r'\n?DEVICE="\$\{DEVICE:-cuda\}".*', "", block)
    block = block.replace(' --device "$DEVICE"', "")
    block = block.replace("predictionio_tpu_torch.", "predictionio_tpu.")
    for jax_port, port in PORTS.items():
        block = re.sub(rf"\b{port}\b", str(jax_port), block)
    return block


@pytest.mark.parametrize("doc", DOCS)
def test_torch_quickstart_doc_matches_its_jax_twin(doc):
    port, jax = (_bash_blocks(_read(folder, doc)) for folder in ("docs_torch", "docs"))
    assert len(port) == len(jax)
    port_engine, jax_engine = _engine_json(port), _engine_json(jax)
    if jax_engine is not None:
        assert port_engine["engineFactory"] == jax_engine["engineFactory"].replace(
            "predictionio_tpu.", "predictionio_tpu_torch.")
        for engine in (port_engine, jax_engine):
            engine.pop("engineFactory")
        assert port_engine == jax_engine
    # step for step: each block is its twin, PATH, device, factories and
    # ports apart; the device is set once and passed to train, deploy, eval
    for p, j in zip(port, jax):
        comment = re.compile(r"[ \t]+# .*$", re.M)
        assert comment.sub("", _as_jax(p)) == comment.sub("", j)
    text = "\n".join(port)
    assert text.count('DEVICE="${DEVICE:-cuda}"') == 1
    for command in ("pio train", "pio deploy", "pio eval"):
        for line in re.findall(rf"^{command}\b.*$", text, re.M):
            assert '--device "$DEVICE"' in line, line
