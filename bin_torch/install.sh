#!/usr/bin/env bash
# Editable install of the framework (role of bin/install.sh). From the
# port's unpacked tarball it installs the port alone, with its `pio-torch`
# console script.
set -e
cd "$(dirname "$0")/.."
"${PIO_PYTHON:-python3}" -m pip install -e .
echo "Installed. Try: pio-torch status"
