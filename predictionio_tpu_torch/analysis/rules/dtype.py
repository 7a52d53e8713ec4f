"""dtype-discipline: compute modules stay f32/bf16
(a copy of the JAX package's ``analysis/rules/dtype.py``).

The card's throughput and its HBM budget both assume 32-bit (or
narrower) floats; a ``float64`` tensor runs at a fraction of the card's
f32 and bf16 rates and doubles memory traffic.
Any ``float64`` in ops/, models/ or e2/ is therefore a finding unless
the site carries a numerical-stability justification — exact linear
solves in a parity oracle earn a suppression; "it was numpy's default"
does not.

Flagged forms: ``<mod>.float64`` attributes (np/jnp/numpy/torch/...),
``dtype="float64"`` string constants, and ``.astype("float64")``.
"""

from __future__ import annotations

import ast
from typing import Any

from predictionio_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register_rule

WIDE_DTYPES = ("float64", "complex128", "int64")
#: int64 indices are routinely legitimate (vocab > 2^31 never is here,
#: but jnp defaults int32 anyway) — only the float widths are policed
#: by default; options can extend.
DEFAULT_POLICED = ("float64", "complex128")


@register_rule
class DtypeDisciplineRule(Rule):
    rule_id = "dtype-discipline"
    description = "no float64/complex128 on the device compute path"
    default_paths = ("ops/", "models/", "e2/")

    def check(self, module: ModuleInfo, options: dict[str, Any]) -> list[Finding]:
        policed = set(options.get("policed_dtypes", DEFAULT_POLICED))
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            # np.float64 / jnp.float64 / numpy.float64 attribute use
            if isinstance(node, ast.Attribute) and node.attr in policed:
                findings.append(self._finding(node, node.attr))
            # dtype="float64" and .astype("float64")
            elif (isinstance(node, ast.keyword) and node.arg == "dtype"
                    and isinstance(node.value, ast.Constant)
                    and node.value.value in policed):
                findings.append(self._finding(node.value, node.value.value))
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "astype"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value in policed):
                findings.append(self._finding(node.args[0], node.args[0].value))
        return findings

    def _finding(self, node: ast.AST, dtype: str) -> Finding:
        return Finding(
            self.rule_id, "", node.lineno,
            f"{dtype} on the compute path — the card runs f64 at a "
            f"fraction of its f32/bf16 rates and it doubles HBM "
            f"traffic; use float32/bfloat16, or suppress with a "
            f"numerical-stability "
            f"justification", getattr(node, "col_offset", 0))
