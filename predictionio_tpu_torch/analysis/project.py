"""Whole-program model backing the project-level lint passes
(a copy of the JAX package's ``analysis/project.py``).

``ProjectModel`` is built once per run from every parsed module and
resolves what a single-file pass cannot: the import graph, a
class/attribute model with per-class lock inventory, a call graph over
resolvable receivers (``self.m()``, typed locals/params, ``self.attr``
chains, module functions through imports), every thread-spawn /
executor-submit / timer site with the objects it hands across the
boundary, lock-acquisition spans, and the registry of ``@jax.jit`` /
``pjit`` entry points with their static-argument menus.

What it deliberately gives up on (documented for rule authors and in
docs/static-analysis.md):

- untyped receivers — a call through a bare parameter or a container
  subscript (``self._queue.get()``) resolves to nothing, so state that
  only travels through such an edge is invisible to the race pass (the
  per-file ``lock-discipline`` rule stays on as the fallback there);
- instance identity — locks are identified by ``(class, attr)`` or
  ``(module, name)``, not by object, so edges reached through a
  non-``self`` receiver of the holder's own class are skipped rather
  than risk a different-instance false positive;
- nested ``def`` thread targets — ``Thread(target=runner)`` where
  ``runner`` is a closure is not treated as an entry (its accesses
  would be attributed to the enclosing function);
- dynamic dispatch, ``getattr``, monkey-patching, and anything behind
  ``exec``.

Two soundness refinements keep the race pass usable on real code:

- writes in ``__init__``/``__post_init__`` via ``self``, and accesses
  through a local name bound to a constructor call in the same
  function, are pre-publication and excluded;
- a function whose every resolved call site holds lock L inherits L
  (3-round intersection fixpoint), so the ``_swap``-style "caller
  holds the lock" idiom does not false-positive.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Iterable

from predictionio_tpu_torch.analysis.core import ModuleInfo, Rule

#: constructors (threading.*) whose assignment marks an attr/var a lock;
#: value = reentrant (with-ing one you already hold is legal)
LOCK_CTORS = {
    "Lock": False,
    "RLock": True,
    # Condition() wraps an RLock by default
    "Condition": True,
    "Semaphore": False,
    "BoundedSemaphore": False,
}

#: lock identity for a with-expression we could not resolve but that
#: looks lock-ish — conservatively treated as matching every lock
WILDCARD_LOCK = ("?", "?")

READ, WRITE = "read", "write"

_THREAD_CTORS = ("Thread",)
_TIMER_CTORS = ("Timer",)

_LOCKISH = ("lock", "mutex", "_cv", "cond")


def _lockish(name: str) -> bool:
    low = name.lower()
    return any(tag in low for tag in _LOCKISH)


def module_key(relpath: str) -> str:
    """``fleet/gateway.py`` -> ``fleet.gateway``; ``fleet/__init__.py``
    -> ``fleet`` (the package itself)."""
    key = relpath[:-3] if relpath.endswith(".py") else relpath
    key = key.replace("/", ".")
    if key.endswith(".__init__"):
        key = key[: -len(".__init__")]
    return key or "__init__"


@dataclasses.dataclass
class ClassModel:
    key: str                 #: ``fleet.gateway:EngineGroup``
    name: str
    module: str              #: package-relative path
    node: ast.ClassDef
    methods: dict[str, ast.FunctionDef] = dataclasses.field(default_factory=dict)
    properties: set[str] = dataclasses.field(default_factory=set)
    #: attr -> reentrant? for attrs assigned a threading lock ctor
    lock_attrs: dict[str, bool] = dataclasses.field(default_factory=dict)
    #: attr -> class key, from ``self.x = Cls(...)`` / annotations
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AttrAccess:
    """One read/write of ``<cls_key>.<attr>`` observed in ``func``."""

    cls_key: str
    attr: str
    kind: str                #: READ or WRITE
    func: str                #: function unit key where it happens
    module: str              #: package-relative path of that unit
    line: int
    col: int
    node: ast.AST
    via_self: bool
    #: pre-publication (ctor-local object / __init__ self-write)
    fresh: bool = False


@dataclasses.dataclass
class CallEdge:
    callee: str              #: function unit key
    node: ast.Call | ast.Attribute
    #: receiver is literally ``self`` — lock identity provably shared
    same_instance: bool


@dataclasses.dataclass
class Acquire:
    lock: tuple[str, str]
    node: ast.With


@dataclasses.dataclass
class Spawn:
    """A Thread/Timer construction or an executor ``.submit``."""

    kind: str                #: "thread" | "timer" | "submit"
    target: str              #: function unit key the new context enters
    module: str
    line: int
    func: str                #: spawning function unit key
    #: target param name -> class key, for args escaping the boundary
    bindings: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class JitEntry:
    key: str
    name: str
    module: str
    line: int
    params: tuple[str, ...]
    static_params: tuple[str, ...]


@dataclasses.dataclass
class JitCallSite:
    entry: str               #: JitEntry key
    node: ast.Call
    func: str                #: calling unit key
    module: str


class FunctionUnit:
    """One top-level ``def`` (module function or method); nested defs
    fold into their parent unit."""

    def __init__(self, key: str, module: str, mkey: str,
                 node: ast.FunctionDef, cls: ClassModel | None, name: str):
        self.key = key
        self.module = module
        self.mkey = mkey
        self.node = node
        self.cls = cls
        self.name = name
        self.env: dict[str, str] = {}
        self.assigns: dict[str, ast.expr] = {}
        self.calls: list[CallEdge] = []
        self.accesses: list[AttrAccess] = []
        self.acquires: list[Acquire] = []
        #: local names bound to a constructor call in this unit
        self.fresh_locals: set[str] = set()


_JIT_DECOS = ("jit", "pjit", "instrumented_jit")


class ProjectModel:
    """See module docstring. Construct with ``{relpath: ModuleInfo}``."""

    def __init__(self, modules: dict[str, ModuleInfo]):
        self.modules = modules
        self.mkeys: dict[str, str] = {module_key(rp): rp for rp in modules}
        self.classes: dict[str, ClassModel] = {}
        self.functions: dict[str, FunctionUnit] = {}
        #: mkey -> local name -> dotted import target
        self.imports: dict[str, dict[str, str]] = {}
        #: mkey -> module-level var -> class key
        self.module_var_types: dict[str, dict[str, str]] = {}
        #: mkey -> module-level lock var -> reentrant?
        self.module_locks: dict[str, dict[str, bool]] = {}
        #: mkey -> UPPERCASE module-level constant names
        self.module_constants: dict[str, set[str]] = {}
        self.spawns: list[Spawn] = []
        self.jit_entries: dict[str, JitEntry] = {}
        self.jit_call_sites: list[JitCallSite] = []

        self._thread_reach: dict[str, Spawn] | None = None
        self._inherited: dict[str, frozenset] = {}
        self._closure_memo: dict[str, frozenset] = {}
        self._callers: dict[str, list[tuple[str, ast.AST]]] = {}

        for rp, mod in sorted(modules.items()):
            self._collect_module(rp, mod)
        # resolve class attr annotations now that every class exists
        for cls in self.classes.values():
            self._finish_class(cls)
        self._resolve_module_var_types()
        for unit in self.functions.values():
            self._build_env(unit)
        self._collect_spawns()
        self._seed_spawn_bindings()
        for unit in self.functions.values():
            self._collect_facts(unit)
        self._index_callers()
        self._solve_inherited_locks()

    # ------------------------------------------------------------------
    # pass A: symbols
    # ------------------------------------------------------------------

    def _collect_module(self, relpath: str, mod: ModuleInfo) -> None:
        mkey = module_key(relpath)
        imports: dict[str, str] = {}
        self.imports[mkey] = imports
        self.module_var_types[mkey] = {}
        self.module_locks[mkey] = {}
        self.module_constants[mkey] = set()

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        imports[alias.asname] = alias.name
                    else:
                        # ``import a.b`` binds ``a``; attribute chains
                        # rejoin the rest at resolution time
                        top = alias.name.split(".")[0]
                        imports[top] = top
            elif isinstance(node, ast.ImportFrom):
                base = self._import_base(mkey, node)
                if base is None:
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    imports[local] = f"{base}.{alias.name}" if base else alias.name

        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                self._collect_class(relpath, mkey, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = f"{mkey}:{node.name}"
                self.functions[key] = FunctionUnit(
                    key, relpath, mkey, node, None, node.name)
                self._maybe_jit_entry(key, relpath, mkey, node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if name.isupper():
                    self.module_constants[mkey].add(name)
                ctor = self._lock_ctor(node.value)
                if ctor is not None:
                    self.module_locks[mkey][name] = ctor
                elif isinstance(node.value, ast.Call):
                    # module-level shared object: ``CURSOR = SharedCursor()``
                    self.module_var_types[mkey][name] = "?pending"
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                if node.target.id.isupper():
                    self.module_constants[mkey].add(node.target.id)

    def _import_base(self, mkey: str, node: ast.ImportFrom) -> str | None:
        if node.level == 0:
            return node.module or ""
        parts = mkey.split(".")
        # the module's package = mkey minus the final component (mkey of
        # an __init__ already IS the package)
        pkg = parts if self.mkeys.get(mkey, "").endswith("__init__.py") else parts[:-1]
        drop = node.level - 1
        if drop > len(pkg):
            return None
        base = pkg[: len(pkg) - drop]
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base)

    def _collect_class(self, relpath: str, mkey: str, node: ast.ClassDef) -> None:
        key = f"{mkey}:{node.name}"
        cls = ClassModel(key=key, name=node.name, module=relpath, node=node)
        self.classes[key] = cls
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls.methods[item.name] = item
                for deco in item.decorator_list:
                    dotted = Rule.dotted_name(deco) or ""
                    if dotted.split(".")[-1] in ("property", "cached_property"):
                        cls.properties.add(item.name)
                fkey = f"{mkey}:{node.name}.{item.name}"
                self.functions[fkey] = FunctionUnit(
                    fkey, relpath, mkey, item, cls, f"{node.name}.{item.name}")
            elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                # dataclass-style field declaration
                cls.attr_types.setdefault(item.target.id, "?ann")
        # lock attrs / attr types from self-assignments anywhere in the body
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Assign) or len(sub.targets) != 1:
                continue
            tgt = sub.targets[0]
            if not (isinstance(tgt, ast.Attribute) and
                    isinstance(tgt.value, ast.Name) and tgt.value.id == "self"):
                continue
            ctor = self._lock_ctor(sub.value)
            if ctor is not None:
                cls.lock_attrs[tgt.attr] = ctor

    def _finish_class(self, cls: ClassModel) -> None:
        mkey = module_key(cls.module)
        # annotated fields: resolve the annotation to a class now
        for item in cls.node.body:
            if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                resolved = self._annotation_class(mkey, item.annotation)
                if resolved:
                    cls.attr_types[item.target.id] = resolved
                elif cls.attr_types.get(item.target.id) == "?ann":
                    del cls.attr_types[item.target.id]
        # self.x = Cls(...), annotated self.x: Cls, and self.x = <param>
        # where the enclosing method annotates the param
        for meth in cls.methods.values():
            params: dict[str, str] = {}
            margs = meth.args
            for a in (list(margs.posonlyargs) + list(margs.args)
                      + list(margs.kwonlyargs)):
                t = self._annotation_class(mkey, a.annotation)
                if t:
                    params[a.arg] = t
            for sub in ast.walk(meth):
                tgt = None
                ann = None
                value = None
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    tgt, value = sub.targets[0], sub.value
                elif isinstance(sub, ast.AnnAssign):
                    tgt, ann, value = sub.target, sub.annotation, sub.value
                if not (isinstance(tgt, ast.Attribute) and
                        isinstance(tgt.value, ast.Name) and tgt.value.id == "self"):
                    continue
                resolved = (self._annotation_class(mkey, ann)
                            if ann is not None else None)
                if resolved is None and isinstance(value, ast.Call):
                    resolved = self._resolve_class(
                        mkey, Rule.dotted_name(value.func) or "")
                if resolved is None and isinstance(value, ast.Name):
                    resolved = params.get(value.id)
                if resolved:
                    cls.attr_types.setdefault(tgt.attr, resolved)

    @staticmethod
    def _lock_ctor(value: ast.AST) -> bool | None:
        """reentrant-flag when ``value`` constructs a threading lock."""
        if not isinstance(value, ast.Call):
            return None
        name = Rule.dotted_name(value.func) or ""
        last = name.split(".")[-1]
        return LOCK_CTORS.get(last)

    # ------------------------------------------------------------------
    # name resolution
    # ------------------------------------------------------------------

    def _find_module(self, dotted: str) -> tuple[str, list[str]] | None:
        """Split ``dotted`` into (known module key, symbol chain),
        matching the longest module prefix; up to two leading package
        components (e.g. ``predictionio_tpu_torch.``) may be stripped."""
        parts = dotted.split(".")
        for strip in range(0, 3):
            rest = parts[strip:]
            if not rest:
                continue
            for cut in range(len(rest), 0, -1):
                cand = ".".join(rest[:cut])
                if cand in self.mkeys:
                    return cand, rest[cut:]
        return None

    def _resolve_symbol(self, mkey: str, dotted: str) -> tuple[str, str] | None:
        """Resolve ``dotted`` as seen from module ``mkey`` to
        ("class"|"func", key)."""
        if not dotted:
            return None
        parts = dotted.split(".")
        imports = self.imports.get(mkey, {})
        if parts[0] not in imports:
            got = self._symbol_in(mkey, parts)
            if got is not None:
                return got
        else:
            dotted = ".".join([imports[parts[0]]] + parts[1:])
        # absolute path (possibly package-prefixed) to another module
        found = self._find_module(dotted)
        if not found:
            return None
        mk, chain = found
        return self._symbol_in(mk, chain)

    def _symbol_in(self, mk: str, chain: list[str]) -> tuple[str, str] | None:
        if not chain:
            return None
        ckey = f"{mk}:{chain[0]}"
        if len(chain) == 1:
            if ckey in self.classes:
                return "class", ckey
            if ckey in self.functions:
                return "func", ckey
            return None
        if len(chain) == 2 and ckey in self.classes:
            fkey = f"{ckey}.{chain[1]}"
            if fkey in self.functions:
                return "func", fkey
        return None

    def _resolve_class(self, mkey: str, dotted: str) -> str | None:
        got = self._resolve_symbol(mkey, dotted)
        return got[1] if got and got[0] == "class" else None

    def _annotation_class(self, mkey: str, ann: ast.AST | None) -> str | None:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            return (self._annotation_class(mkey, ann.left)
                    or self._annotation_class(mkey, ann.right))
        if isinstance(ann, ast.Constant):   # the None half of "X | None"
            return None
        if isinstance(ann, ast.Subscript):
            base = (Rule.dotted_name(ann.value) or "").split(".")[-1]
            if base in ("Optional", "Final", "Annotated", "ClassVar"):
                inner = ann.slice
                if isinstance(inner, ast.Tuple) and inner.elts:
                    inner = inner.elts[0]
                return self._annotation_class(mkey, inner)
            return None   # generics (dict[str, X]) are a documented give-up
        dotted = Rule.dotted_name(ann)
        if dotted:
            return self._resolve_class(mkey, dotted)
        return None

    # ------------------------------------------------------------------
    # pass B1: per-unit type environments
    # ------------------------------------------------------------------

    def _build_env(self, unit: FunctionUnit) -> None:
        env = unit.env
        if unit.cls is not None:
            env["self"] = unit.cls.key
        args = unit.node.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            t = self._annotation_class(unit.mkey, a.annotation)
            if t:
                env[a.arg] = t
        # two mini-passes so ``y = x`` after ``x = Cls()`` resolves
        for _ in range(2):
            for node in ast.walk(unit.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    name = node.targets[0].id
                    unit.assigns[name] = node.value
                    t = self._expr_class(unit, node.value)
                    if t:
                        env[name] = t
                        if isinstance(node.value, ast.Call):
                            unit.fresh_locals.add(name)
                elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                    t = self._annotation_class(unit.mkey, node.annotation)
                    if t:
                        env[node.target.id] = t
        # resolve module-level shared objects visible from this unit
        mod_vars = self.module_var_types.get(unit.mkey, {})
        for name, t in mod_vars.items():
            env.setdefault(name, t)

    def _expr_class(self, unit: FunctionUnit, expr: ast.AST) -> str | None:
        got: str | None = None
        if isinstance(expr, ast.Name):
            got = unit.env.get(expr.id)
        elif isinstance(expr, ast.Call):
            sym = self._resolve_symbol(unit.mkey, Rule.dotted_name(expr.func) or "")
            if sym and sym[0] == "class":
                got = sym[1]
            elif sym and sym[0] == "func":
                fn = self.functions[sym[1]]
                got = self._annotation_class(fn.mkey, fn.node.returns)
            elif isinstance(expr.func, ast.Attribute):
                # method call on a typed receiver with a typed return
                owner = self._expr_class(unit, expr.func.value)
                if owner and expr.func.attr in self.classes[owner].methods:
                    m = self.classes[owner].methods[expr.func.attr]
                    got = self._annotation_class(
                        module_key(self.classes[owner].module), m.returns)
        elif isinstance(expr, ast.Attribute):
            owner = self._expr_class(unit, expr.value)
            if owner is not None:
                got = self.classes[owner].attr_types.get(expr.attr)
        return got if got in self.classes else None

    # ------------------------------------------------------------------
    # module-level shared objects (needs classes + imports, no env)
    # ------------------------------------------------------------------

    def _resolve_module_var_types(self) -> None:
        for mkey in list(self.module_var_types):
            relpath = self.mkeys.get(mkey)
            if not relpath:
                continue
            mod = self.modules[relpath]
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call):
                    resolved = self._resolve_class(
                        mkey, Rule.dotted_name(node.value.func) or "")
                    name = node.targets[0].id
                    if resolved:
                        self.module_var_types[mkey][name] = resolved
                    else:
                        self.module_var_types[mkey].pop(name, None)

    # ------------------------------------------------------------------
    # pass B: spawns then facts
    # ------------------------------------------------------------------

    def _collect_spawns(self) -> None:
        for unit in self.functions.values():
            for node in ast.walk(unit.node):
                if not isinstance(node, ast.Call):
                    continue
                spawn = self._spawn_of(unit, node)
                if spawn is not None:
                    self.spawns.append(spawn)

    def _spawn_of(self, unit: FunctionUnit, call: ast.Call) -> Spawn | None:
        last = (Rule.dotted_name(call.func) or "").split(".")[-1]
        target_expr: ast.AST | None = None
        escaped: list[ast.AST] = []
        kind = None
        if last in _THREAD_CTORS:
            kind = "thread"
            for kw in call.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
                elif kw.arg == "args" and isinstance(kw.value, (ast.Tuple, ast.List)):
                    escaped = list(kw.value.elts)
        elif last in _TIMER_CTORS:
            kind = "timer"
            if len(call.args) >= 2:
                target_expr = call.args[1]
            for kw in call.keywords:
                if kw.arg == "function":
                    target_expr = kw.value
                elif kw.arg == "args" and isinstance(kw.value, (ast.Tuple, ast.List)):
                    escaped = list(kw.value.elts)
        elif isinstance(call.func, ast.Attribute) and call.func.attr == "submit" \
                and call.args:
            kind = "submit"
            target_expr = call.args[0]
            escaped = list(call.args[1:])
        if kind is None or target_expr is None:
            return None
        target = self._callable_key(unit, target_expr)
        if target is None:
            return None
        bindings: dict[str, str] = {}
        if escaped:
            tunit = self.functions[target]
            params = [a.arg for a in tunit.node.args.args]
            if tunit.cls is not None and params and params[0] == "self":
                params = params[1:]
            for p, arg in zip(params, escaped):
                t = self._expr_class(unit, arg)
                if t:
                    bindings[p] = t
        return Spawn(kind=kind, target=target, module=unit.module,
                     line=call.lineno, func=unit.key, bindings=bindings)

    def _callable_key(self, unit: FunctionUnit, expr: ast.AST) -> str | None:
        """Resolve a callable reference (not a call) to a unit key."""
        if isinstance(expr, ast.Attribute):
            owner = self._expr_class(unit, expr.value)
            if owner and expr.attr in self.classes[owner].methods:
                return f"{owner}.{expr.attr}"
            got = self._resolve_symbol(unit.mkey, Rule.dotted_name(expr) or "")
            if got and got[0] == "func":
                return got[1]
            return None
        if isinstance(expr, ast.Name):
            got = self._resolve_symbol(unit.mkey, expr.id)
            if got and got[0] == "func":
                return got[1]
            if got and got[0] == "class":
                init = f"{got[1]}.__init__"
                return init if init in self.functions else None
        return None

    def _seed_spawn_bindings(self) -> None:
        reseed: set[str] = set()
        for spawn in self.spawns:
            if not spawn.bindings:
                continue
            tunit = self.functions[spawn.target]
            for p, t in spawn.bindings.items():
                if tunit.env.setdefault(p, t) == t:
                    reseed.add(tunit.key)
        # param typing may unlock ``x = param`` propagation inside
        for key in reseed:
            self._build_env(self.functions[key])

    def _collect_facts(self, unit: FunctionUnit) -> None:
        init_like = unit.cls is not None and unit.node.name in (
            "__init__", "__post_init__")
        mod = self.modules[unit.module]
        for node in ast.walk(unit.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lid = self._lock_id(unit, item.context_expr)
                    if lid is not None:
                        unit.acquires.append(Acquire(lock=lid, node=node))
            elif isinstance(node, ast.Call):
                self._record_call(unit, node)
            elif isinstance(node, ast.Attribute):
                self._record_access(unit, node, mod, init_like)
            elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Attribute):
                # the Store-ctx target is also a read
                self._record_access(unit, node.target, mod, init_like,
                                    force_kind=READ)

    def _record_call(self, unit: FunctionUnit, call: ast.Call) -> None:
        func = call.func
        callee: str | None = None
        same_instance = False
        if isinstance(func, ast.Attribute):
            owner = self._expr_class(unit, func.value)
            if owner and func.attr in self.classes[owner].methods:
                callee = f"{owner}.{func.attr}"
                same_instance = (isinstance(func.value, ast.Name)
                                 and func.value.id == "self")
            else:
                got = self._resolve_symbol(unit.mkey, Rule.dotted_name(func) or "")
                if got and got[0] == "func":
                    callee = got[1]
        elif isinstance(func, ast.Name):
            got = self._resolve_symbol(unit.mkey, func.id)
            if got and got[0] == "func":
                callee = got[1]
            elif got and got[0] == "class":
                init = f"{got[1]}.__init__"
                callee = init if init in self.functions else None
        if callee is not None and callee in self.functions:
            unit.calls.append(CallEdge(callee=callee, node=call,
                                       same_instance=same_instance))
            if callee in self.jit_entries:
                self.jit_call_sites.append(JitCallSite(
                    entry=callee, node=call, func=unit.key, module=unit.module))

    def _record_access(self, unit: FunctionUnit, node: ast.Attribute,
                       mod: ModuleInfo, init_like: bool,
                       force_kind: str | None = None) -> None:
        owner = self._expr_class(unit, node.value)
        if owner is None:
            return
        cls = self.classes[owner]
        if node.attr in cls.methods and node.attr not in cls.properties:
            return                          # method reference, not state
        if node.attr in cls.lock_attrs:
            return                          # the lock itself is not data
        via_self = isinstance(node.value, ast.Name) and node.value.id == "self"
        if node.attr in cls.properties:
            # a property read is a call to its getter
            if isinstance(node.ctx, ast.Load):
                unit.calls.append(CallEdge(
                    callee=f"{owner}.{node.attr}", node=node,
                    same_instance=via_self))
            return
        if force_kind is not None:
            kind = force_kind
        elif isinstance(node.ctx, (ast.Store, ast.Del)):
            kind = WRITE
        else:
            kind = READ
        fresh = bool(
            (init_like and via_self)
            or (isinstance(node.value, ast.Name)
                and node.value.id in unit.fresh_locals)
        )
        unit.accesses.append(AttrAccess(
            cls_key=owner, attr=node.attr, kind=kind, func=unit.key,
            module=unit.module, line=node.lineno, col=node.col_offset,
            node=node, via_self=via_self, fresh=fresh))

    def _lock_id(self, unit: FunctionUnit, expr: ast.AST) -> tuple[str, str] | None:
        if isinstance(expr, ast.Attribute):
            owner = self._expr_class(unit, expr.value)
            if owner is not None and (expr.attr in self.classes[owner].lock_attrs
                                      or _lockish(expr.attr)):
                return (owner, expr.attr)
            return WILDCARD_LOCK if _lockish(expr.attr) else None
        if isinstance(expr, ast.Name):
            if expr.id in self.module_locks.get(unit.mkey, {}):
                return (f"module:{unit.mkey}", expr.id)
            return WILDCARD_LOCK if _lockish(expr.id) else None
        try:
            text = ast.unparse(expr)
        except Exception:
            return None
        return WILDCARD_LOCK if _lockish(text) else None

    def lock_reentrant(self, lock: tuple[str, str]) -> bool:
        owner, name = lock
        if owner.startswith("module:"):
            return self.module_locks.get(owner[len("module:"):], {}).get(name, False)
        cls = self.classes.get(owner)
        if cls is None:
            return False
        return cls.lock_attrs.get(name, False)

    # ------------------------------------------------------------------
    # jit entries
    # ------------------------------------------------------------------

    def _maybe_jit_entry(self, key: str, relpath: str, mkey: str,
                         node: ast.FunctionDef) -> None:
        static: set[str] = set()
        nums: set[int] = set()
        is_jit = False
        for deco in node.decorator_list:
            call = deco if isinstance(deco, ast.Call) else None
            base = call.func if call else deco
            dotted = (Rule.dotted_name(base) or "").split(".")[-1]
            if dotted in _JIT_DECOS:
                is_jit = True
            elif dotted == "partial" and call and call.args:
                inner = (Rule.dotted_name(call.args[0]) or "").split(".")[-1]
                if inner in _JIT_DECOS:
                    is_jit = True
            if not is_jit or call is None:
                continue
            for kw in call.keywords:
                if kw.arg == "static_argnames":
                    static |= set(_const_strs(kw.value))
                elif kw.arg == "static_argnums":
                    nums |= set(_const_ints(kw.value))
        if not is_jit:
            return
        params = tuple(a.arg for a in (list(node.args.posonlyargs)
                                       + list(node.args.args)))
        for i in nums:
            if 0 <= i < len(params):
                static.add(params[i])
        self.jit_entries[key] = JitEntry(
            key=key, name=node.name, module=relpath, line=node.lineno,
            params=params, static_params=tuple(sorted(static)))

    # ------------------------------------------------------------------
    # derived graphs
    # ------------------------------------------------------------------

    def _index_callers(self) -> None:
        for unit in self.functions.values():
            for edge in unit.calls:
                self._callers.setdefault(edge.callee, []).append(
                    (unit.key, edge.node))

    def thread_reachable(self) -> dict[str, Spawn]:
        """function unit key -> the Spawn whose context first reaches it."""
        if self._thread_reach is not None:
            return self._thread_reach
        reach: dict[str, Spawn] = {}
        frontier: list[tuple[str, Spawn]] = []
        for spawn in self.spawns:
            if spawn.target not in reach:
                reach[spawn.target] = spawn
                frontier.append((spawn.target, spawn))
        while frontier:
            key, origin = frontier.pop()
            unit = self.functions.get(key)
            if unit is None:
                continue
            for edge in unit.calls:
                if edge.callee not in reach:
                    reach[edge.callee] = origin
                    frontier.append((edge.callee, origin))
        self._thread_reach = reach
        return reach

    def ancestor_locks(self, unit: FunctionUnit, node: ast.AST) -> frozenset:
        """Locks held at ``node`` by enclosing ``with`` statements in
        the same unit (inherited caller-held locks NOT included)."""
        mod = self.modules[unit.module]
        held: set = set()
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    lid = self._lock_id(unit, item.context_expr)
                    if lid is not None:
                        held.add(lid)
            if anc is unit.node:
                break
        return frozenset(held)

    def inherited_locks(self, key: str) -> frozenset:
        """Locks held at EVERY resolved call site of ``key`` (empty for
        thread entries and functions with no resolved callers)."""
        return self._inherited.get(key, frozenset())

    def _solve_inherited_locks(self) -> None:
        entries = {s.target for s in self.spawns}
        inherited: dict[str, frozenset] = {k: frozenset() for k in self.functions}
        for _ in range(3):
            nxt: dict[str, frozenset] = {}
            for key in self.functions:
                callers = self._callers.get(key)
                if not callers or key in entries:
                    nxt[key] = frozenset()
                    continue
                acc: frozenset | None = None
                for caller_key, node in callers:
                    caller = self.functions[caller_key]
                    held = self.ancestor_locks(caller, node) | inherited[caller_key]
                    acc = held if acc is None else (acc & held)
                nxt[key] = acc or frozenset()
            if nxt == inherited:
                break
            inherited = nxt
        self._inherited = inherited

    def locks_held_at(self, unit: FunctionUnit, node: ast.AST) -> frozenset:
        return self.ancestor_locks(unit, node) | self.inherited_locks(unit.key)

    def lock_closure(self, key: str, _depth: int = 0,
                     _seen: frozenset = frozenset()) -> frozenset:
        """All locks ``key`` may acquire, directly or through resolved
        calls (bounded depth, memoized)."""
        memo = self._closure_memo.get(key)
        if memo is not None:
            return memo
        if _depth > 10 or key in _seen:
            return frozenset()
        unit = self.functions.get(key)
        if unit is None:
            return frozenset()
        out: set = {a.lock for a in unit.acquires if a.lock != WILDCARD_LOCK}
        seen = _seen | {key}
        for edge in unit.calls:
            out |= self.lock_closure(edge.callee, _depth + 1, seen)
        result = frozenset(out)
        if not _seen:                       # only memoize complete walks
            self._closure_memo[key] = result
        return result

    def direct_acquires(self, key: str) -> frozenset:
        unit = self.functions.get(key)
        if unit is None:
            return frozenset()
        return frozenset(a.lock for a in unit.acquires
                         if a.lock != WILDCARD_LOCK)


def _const_strs(node: ast.AST) -> Iterable[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _const_strs(e)


def _const_ints(node: ast.AST) -> Iterable[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        yield node.value
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _const_ints(e)


def lock_label(lock: tuple[str, str]) -> str:
    owner, name = lock
    if owner.startswith("module:"):
        return f"{owner[len('module:'):]}.{name}"
    return f"{owner.split(':')[-1]}.{name}" if owner != "?" else "<unresolved lock>"
