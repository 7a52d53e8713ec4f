"""The classification, evaluation and sessionrec walk-throughs of
``docs_torch/`` run verbatim on the CPU, as tests/test_torch_quickstart_docs.py
runs the ALS ones (the two files split the six so that the test runner
can run them side by side).
"""

from __future__ import annotations

import pytest

from test_torch_quickstart_docs import ALS_DOCS, DOCS, check_runs_verbatim


@pytest.mark.parametrize("doc", [d for d in DOCS if d not in ALS_DOCS])
def test_torch_quickstart_doc_runs_verbatim(doc):
    check_runs_verbatim(doc)
