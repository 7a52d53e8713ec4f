"""host-sync-in-hot-path: no device→host synchronization while a
request handler holds the socket
(a copy of the JAX package's ``analysis/rules/host_sync.py``).

``.item()``, ``float(jnp_value)``, ``np.asarray(jax_value)``,
``jax.device_get``, ``.block_until_ready()`` and, on the card,
``float(torch_value)`` and ``torch.cuda.synchronize()`` all block the
calling thread until the device finishes and the value lands on host.
On the serving path that turns one stray scalar read into a full
device round-trip per request. Models must return device arrays; the
serving layer converts ONCE at the wire boundary (core/wire.to_wire),
outside the scope of this rule.

Heuristics, tuned to zero false positives on the current tree:
``float()``/``int()``/``np.asarray()`` are flagged only when their
argument expression textually references ``jnp.``/``jax.``/``torch.``
— a plain ``float(header_value)`` stays legal. The JAX spellings stay
beside the torch ones, so the two packages' rules give the same
findings on the same source.
"""

from __future__ import annotations

import ast
from typing import Any

from predictionio_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register_rule

#: zero-arg methods that force a device sync wherever they appear
SYNC_METHODS = ("item", "block_until_ready")

#: converters that sync only when fed a device value
CONVERTERS = ("float", "int", "bool", "np.asarray", "numpy.asarray",
              "np.array", "numpy.array")

JAX_MARKERS = ("jnp.", "jax.", "torch.")

#: calls that drain the device queue wherever they appear, with the
#: words their finding uses
DRAIN_CALLS = {
    "jax.device_get": "forces a device→host transfer per request",
    "torch.cuda.synchronize": "waits for every queued kernel per request",
}


@register_rule
class HostSyncRule(Rule):
    rule_id = "host-sync-in-hot-path"
    description = "no host-device synchronization on the request-serving path"
    default_paths = ("api/", "workflow/deploy.py")

    def check(self, module: ModuleInfo, options: dict[str, Any]) -> list[Finding]:
        sync_methods = set(options.get("sync_methods", SYNC_METHODS))
        converters = set(options.get("converters", CONVERTERS))

        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = self.dotted_name(node.func)
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in sync_methods
                    and not node.args and not node.keywords):
                findings.append(Finding(
                    self.rule_id, "", node.lineno,
                    f".{node.func.attr}() on the serving path blocks the "
                    f"handler thread on a device round-trip — keep values "
                    f"on device until the wire boundary", node.col_offset))
                continue
            if dotted in DRAIN_CALLS:
                findings.append(Finding(
                    self.rule_id, "", node.lineno,
                    f"{dotted}() on the serving path "
                    f"{DRAIN_CALLS[dotted]}", node.col_offset))
                continue
            if dotted in converters and node.args:
                arg_src = ast.unparse(node.args[0])
                if any(m in arg_src for m in JAX_MARKERS):
                    findings.append(Finding(
                        self.rule_id, "", node.lineno,
                        f"{dotted}({arg_src}) converts a device value on "
                        f"the serving path — a hidden blocking sync",
                        node.col_offset))
        return findings
