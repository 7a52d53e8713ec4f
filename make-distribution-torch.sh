#!/usr/bin/env bash
# Build a relocatable distribution tarball of the PyTorch/CUDA port (the
# counterpart of make-distribution.sh): the port's package, bin_torch/,
# conf/ and docs_torch/, versioned from pyproject.toml, with no file of the
# JAX package. The staged pyproject.toml names the port alone: its own
# package, torch in place of jax, and the `pio-torch` console script.
# Unpacked anywhere, bin_torch/pio runs from it, and the kernels and native
# libraries build at first use from its own sources into its own build/.
# Result: dist/predictionio_tpu_torch-<ver>.tar.gz, or under the directory
# given as the one argument.
set -euo pipefail
DIST="$(mkdir -p "${1:-$(dirname "$0")/dist}" && cd "${1:-$(dirname "$0")/dist}" && pwd)"
cd "$(dirname "$0")"
VER=$(python3 -c "
import tomllib
print(tomllib.load(open('pyproject.toml','rb'))['project']['version'])")
NAME="predictionio_tpu_torch-${VER}"
STAGE="${DIST}/${NAME}"
rm -rf "$STAGE" && mkdir -p "$STAGE"
cp -r predictionio_tpu_torch bin_torch conf docs_torch pyproject.toml README.md "$STAGE/"
find "$STAGE" -name '__pycache__' -type d -exec rm -rf {} + 2>/dev/null || true
find "$STAGE" -name '*.so' -delete   # kernels and natives rebuild on first use
python3 - "$STAGE/pyproject.toml" <<'PY'
import re
import sys

path = sys.argv[1]
text = open(path).read()
for pattern, repl in (
        (r'^name = .*$', 'name = "predictionio-tpu-torch"'),
        (r'^description = .*$', 'description = "PyTorch/CUDA port of the TPU-native ML server '
                                'framework: event collection, DASE engines, training and REST '
                                'serving on an NVIDIA GPU"'),
        (r'^dependencies = \[[^\]]*\]', 'dependencies = [\n    "numpy",\n    "torch",\n]'),
        (r'^pio = .*\n', ''),
        (r'^include = .*$', 'include = ["predictionio_tpu_torch*"]')):
    text = re.sub(pattern, repl, text, count=1, flags=re.M)
open(path, "w").write(text)
PY
tar -C "$DIST" -czf "${DIST}/${NAME}.tar.gz" "$NAME"
rm -rf "$STAGE"
echo "${DIST}/${NAME}.tar.gz"
