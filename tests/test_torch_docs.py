"""The port's operator guides (``docs_torch/``) held against the port
itself, on the CPU and at the level of their text: nothing here starts a
server or trains a model.

For each of the 17 guides that ``docs/`` has beside its six quickstart
walk-throughs:

(a) the ``docs_torch/`` twin exists and keeps the JAX guide's ``##``
    sections in order; a section whose subject the port does not have is
    renamed, and ``RENAMED`` lists each rename with its reason;
(b) every relative link and ``#anchor`` resolves inside ``docs_torch/``
    (the port's tarball holds nothing else of the repository); this runs
    over the walk-throughs too;
(c) every ``pio …`` command line of a code block parses with the port's
    own parser (``cli/pio.py``, late-bound subcommands included), with
    ``\\`` continuations joined and environment prefixes stripped;
    ``bin_torch/pio-lint …`` is read as ``pio lint …``;
(d) every ``PIO_*`` variable named is read by the port, its launchers or
    ``conf/``: by name, or through an env prefix the source builds names
    from (``PIO_SERVING_<KEY>``, ``PIO_STORAGE_SOURCES_<NAME>_<KEY>``, …)
    whose ``<KEY>`` the source spells;
(e) every ``pio_*`` metric family named is one the port registers;
(f) the words TPU, XLA, Pallas, jax, pjit, shard_map and jit appear only
    on a line that names the JAX package as the reference;
(g) no ``BENCH_*``, ``bench_*.py``, ``BASELINE`` or ``SURVEY`` reference
    remains, and every paragraph or table that states a measured figure
    names the NVIDIA H100, its power limit, the ``chip_smoke.py`` phase
    and the PR it came from.
"""

from __future__ import annotations

import os
import re
import shlex

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS_DIR = os.path.join(REPO, "docs_torch")

#: the operator guides; the quickstart walk-throughs have their own tests
GUIDES = (
    "index.md", "architecture.md", "migration.md", "quickstart.md", "dase.md",
    "storage.md", "eventserver.md", "operations.md", "operations-resilience.md",
    "data-pipeline.md", "serving-performance.md", "freshness.md",
    "observability.md", "fleet.md", "experimentation.md", "parallelism.md",
    "static-analysis.md",
)

#: ``##`` headings the port renames: {guide: {JAX heading: (port heading, why)}}
RENAMED = {
    "dase.md": {
        "Algorithm taxonomy (mesh placements)": (
            "Algorithm taxonomy (device placements)",
            "the port's placements are torch devices and its own mesh, not a "
            "compiler-partitioned mesh"),
    },
    "operations.md": {
        "bin/ scripts": (
            "bin_torch/ scripts",
            "the port's launchers are bin_torch/; bin/ runs the JAX package"),
    },
    "data-pipeline.md": {
        "Bench methodology": (
            "Measuring on the card",
            "the JAX package's ingest bench and its artifacts are not in the "
            "port's tarball; chip_smoke.py phase 18 measures ingest on the H100"),
    },
    "serving-performance.md": {
        "Benchmarking": (
            "Measuring on the card",
            "the JAX package's serving bench is not in the port's tarball; "
            "chip_smoke.py phases 17, 22 and 27 measure serving on the H100"),
    },
    "observability.md": {
        "Device and compiler observability": (
            "Device and kernel-build observability",
            "the port compiles no programs at run time; what it builds is the "
            "CUDA kernel (nvcc) and the host libraries (g++)"),
    },
    "parallelism.md": {
        "Testing without hardware": (
            "Testing without a card",
            "the port runs its meshes on CPU devices of torch, not on forced "
            "virtual devices of another runtime"),
    },
}

FENCE = re.compile(r"^```.*?^```[ \t]*$", re.M | re.S)


def _read(name: str) -> str:
    with open(os.path.join(DOCS_DIR, name)) as f:
        return f.read()


def _jax_doc(name: str) -> str:
    with open(os.path.join(REPO, "docs", name)) as f:
        return f.read()


def _headings(text: str) -> list[str]:
    return [line[3:].strip() for line in FENCE.sub("", text).splitlines()
            if line.startswith("## ")]


def _anchor(heading: str) -> str:
    """GitHub's anchor of a heading: lower case, punctuation dropped,
    spaces to hyphens."""
    slug = re.sub(r"[^\w\- ]", "", heading.strip().lower())
    return slug.replace(" ", "-")


def _anchors(text: str) -> set[str]:
    return {_anchor(line.lstrip("#")) for line in FENCE.sub("", text).splitlines()
            if re.match(r"#{1,6} ", line)}


def _all_docs() -> list[str]:
    return sorted(n for n in os.listdir(DOCS_DIR) if n.endswith(".md"))


# ---------------------------------------------------------------------------
# (a) twins and sections
# ---------------------------------------------------------------------------

def test_every_guide_of_docs_has_a_twin():
    jax_guides = {n for n in os.listdir(os.path.join(REPO, "docs"))
                  if n.endswith(".md") and not n.startswith("quickstart-")}
    assert jax_guides == set(GUIDES)
    assert set(GUIDES) <= set(_all_docs())


@pytest.mark.parametrize("guide", GUIDES)
def test_sections_follow_the_jax_guide(guide):
    renames = RENAMED.get(guide, {})
    jax_headings = _headings(_jax_doc(guide))
    assert set(renames) <= set(jax_headings), f"{guide}: a rename names no JAX heading"
    want = [renames.get(h, (h,))[0] for h in jax_headings]
    assert _headings(_read(guide)) == want
    for old, (new, why) in renames.items():
        assert new != old and len(why) > 20, (guide, old)


# ---------------------------------------------------------------------------
# (b) links stay inside docs_torch/
# ---------------------------------------------------------------------------

LINK = re.compile(r"(?<!!)\[[^\]]*\]\(([^)\s]+)\)")


@pytest.mark.parametrize("doc", _all_docs())
def test_links_resolve_inside_docs_torch(doc):
    text = FENCE.sub("", _read(doc))
    for target in LINK.findall(text):
        assert not re.match(r"[a-z]+://", target), f"{doc}: external link {target}"
        path, _, anchor = target.partition("#")
        dest = doc if not path else os.path.normpath(path)
        assert not dest.startswith(("..", "/")) and "/" not in dest, \
            f"{doc}: {target} leaves docs_torch/"
        assert dest in _all_docs(), f"{doc}: {target} names no document of docs_torch/"
        if anchor:
            assert anchor in _anchors(_read(dest)), f"{doc}: no #{anchor} in {dest}"


# ---------------------------------------------------------------------------
# (c) command lines parse with the port's parser
# ---------------------------------------------------------------------------

def _port_parser():
    from predictionio_tpu_torch.cli import pio
    import predictionio_tpu_torch.experiment.cli  # noqa: F401  (registers itself)

    parser = pio.build_parser()
    for _name, configure in pio._EXTRA_PARSERS:
        configure(parser.subparsers)
    return parser


def _pio_commands(text: str) -> list[list[str]]:
    """The ``pio`` invocations of the document's code blocks: continuation
    lines joined, a console prompt, environment assignments, comments and
    a shell's control operators and redirections stripped."""
    segments: list[list[str]] = []
    for block in FENCE.findall(text):
        body = re.sub(r"\\\n\s*", " ", "\n".join(block.splitlines()[1:-1]))
        for line in body.splitlines():
            try:
                words = shlex.split(line.strip().removeprefix("$ "), comments=True)
            except ValueError:          # not shell (JSON, Python)
                continue
            segment: list[str] = []
            for word in [*words, ";"]:
                if word in ("&&", "||", "|", ";", "&") or word.startswith((">", "2>")):
                    segments.append(segment)
                    segment = []
                else:
                    segment.append(word)
    commands = []
    for words in segments:
        while words and re.match(r"[A-Z_][A-Z0-9_]*=", words[0]):
            words = words[1:]
        head = os.path.basename(words[0]) if words else ""
        if head in ("pio", "pio-torch"):
            commands.append(words[1:])
        elif head == "pio-lint":
            commands.append(["lint", *words[1:]])
    return commands


@pytest.mark.parametrize("guide", GUIDES)
def test_command_lines_parse(guide):
    parser = _port_parser()
    for argv in _pio_commands(_read(guide)):
        try:
            parser.parse_args(argv)
        except SystemExit as exc:
            pytest.fail(f"{guide}: `pio {' '.join(argv)}` does not parse ({exc.code})")


# ---------------------------------------------------------------------------
# (d) environment variables the port reads
# ---------------------------------------------------------------------------

#: env prefixes whose names carry a user-chosen name before the key
NAMED_PREFIXES = ("PIO_STORAGE_SOURCES_", "PIO_FLEET_ENGINE_")


def _port_sources() -> str:
    texts = []
    for top in ("predictionio_tpu_torch", "bin_torch", "conf"):
        for root, _dirs, files in os.walk(os.path.join(REPO, top)):
            for name in files:
                if name.endswith((".py", ".sh", ".template")) or top == "bin_torch":
                    with open(os.path.join(root, name), errors="replace") as f:
                        texts.append(f.read())
    return "\n".join(texts)


def _env_reader():
    source = _port_sources()
    names = set(re.findall(r"PIO_[A-Z0-9_]+", source))
    prefixes = {n for n in names if n.endswith("_")}
    # quoted keys, and suffixes the source matches names by ("_TYPE")
    keys = {k.lstrip("_") for k in re.findall(r"[\"'](_?[A-Z][A-Z0-9_]*)[\"']", source)}

    def read(var: str) -> bool:
        if var in names:
            return True
        if var.endswith("_"):
            return any(n.startswith(var) for n in names)
        for prefix in prefixes:
            if not var.startswith(prefix):
                continue
            parts = var[len(prefix):].split("_")
            skips = range(len(parts)) if prefix in NAMED_PREFIXES else (0,)
            if any("_".join(parts[i:]) in keys for i in skips):
                return True
        return False

    return read


@pytest.mark.parametrize("guide", GUIDES)
def test_env_variables_are_read_by_the_port(guide):
    read = _env_reader()
    unknown = sorted({v for v in re.findall(r"\bPIO_[A-Z0-9_]+", _read(guide))
                      if not read(v)})
    assert not unknown, f"{guide}: the port reads none of {unknown}"


# ---------------------------------------------------------------------------
# (e) metric families the port registers
# ---------------------------------------------------------------------------

#: ``pio_`` names that are no metric family: storage tables, the
#: feedback loop's entity type
NOT_METRICS = re.compile(r"pio_(event|meta|model_data|store|pr\b)")


def _registered_families() -> set[str]:
    from predictionio_tpu_torch.api.stats import ServingStats
    from predictionio_tpu_torch.fleet.stats import RouterStats
    from predictionio_tpu_torch.utils.resilience import Resilience

    source = _port_sources()
    families = set(re.findall(r"[\"'](pio_[a-z0-9_]*[a-z0-9])[\"']", source))
    families |= {f"pio_serving_{k}_total" for k in ServingStats().raw_counts()}
    families |= {f"pio_router_{k}_total" for k in RouterStats().raw_counts()}
    snap = Resilience.from_properties("docs", {}).snapshot()
    families |= {f"pio_resilience_{k}_total" for k, v in snap.items()
                 if isinstance(v, (int, float))}
    return families


@pytest.mark.parametrize("guide", GUIDES)
def test_metric_families_are_registered(guide):
    families = _registered_families()
    unknown = set()
    for name in re.findall(r"\bpio_[a-z0-9_]+", _read(guide)):
        if NOT_METRICS.match(name):
            continue
        if name.endswith("_"):                      # a placeholder: pio_serving_<counter>_total
            if not any(f.startswith(name) for f in families):
                unknown.add(name)
            continue
        base = re.sub(r"_(bucket|count|sum)$", "", name)
        if name not in families and base not in families:
            unknown.add(name)
    assert not unknown, f"{guide}: the port registers none of {sorted(unknown)}"


# ---------------------------------------------------------------------------
# (f) the reference's words only where the reference is named
# ---------------------------------------------------------------------------

#: identifiers that keep the JAX package's spelling in the port
KEPT_NAMES = re.compile(r"jit-purity|jit-recompile-risk|pio_jit_\w+")
REFERENCE_WORDS = re.compile(r"\b(tpu|xla|pallas|jax|pjit|shard_map|jit)\b", re.I)


@pytest.mark.parametrize("guide", GUIDES)
def test_reference_words_only_beside_the_reference(guide):
    stray = [line for line in _read(guide).splitlines()
             if REFERENCE_WORDS.search(KEPT_NAMES.sub("", line))
             and "jax package" not in line.lower()]
    assert not stray, f"{guide}: {stray[:3]}"


# ---------------------------------------------------------------------------
# (g) no reference benchmark, and every measured figure sourced on the card
# ---------------------------------------------------------------------------

REFERENCE_RECORDS = re.compile(r"BENCH_|bench_\w*\.py|\bbench\.py|BASELINE|SURVEY")
MEASURED = re.compile(
    r"(?<!-)\bmeasured\b|\btook\s+\d"
    r"|(?<!\w)\d[\d,.]*\s*(?:queries/s|events/s|GB/s|TB/s|TFLOP/s)"
    r"|\b(?:p50|p99|median)\b[^|\n]{0,40}?\d[\d.]*\s*(?:ms|s)\b", re.I)
#: a table whose header names a time or a rate holds measurements
MEASURED_TABLE = re.compile(r"queries/s|events/s|\bp50\b|\bp99\b|\bms\b|\bseconds\b|\bfigure\b",
                            re.I)
SOURCED = (re.compile(r"H100"), re.compile(r"\d+(?:\.\d+)? W\b"),
           re.compile(r"\bphases? \d+"), re.compile(r"\bPRs? \d+"))


def _blocks(text: str) -> list[str]:
    """Paragraphs, tables, list items and code blocks: text between blank
    lines, a fenced block whole."""
    parts, pos = [], 0
    for m in FENCE.finditer(text):
        parts += re.split(r"\n\s*\n", text[pos:m.start()])
        parts.append(m.group(0))
        pos = m.end()
    parts += re.split(r"\n\s*\n", text[pos:])
    return [p for p in parts if p.strip()]


@pytest.mark.parametrize("guide", GUIDES)
def test_no_reference_benchmark_and_figures_name_the_card(guide):
    text = _read(guide)
    assert not REFERENCE_RECORDS.search(text), REFERENCE_RECORDS.search(text).group(0)
    for block in _blocks(text):
        header = block.lstrip().splitlines()[0]
        if MEASURED.search(block) or (header.startswith("|") and MEASURED_TABLE.search(header)):
            missing = [p.pattern for p in SOURCED if not p.search(block)]
            assert not missing, f"{guide}: a measured figure lacks {missing}:\n{block}"


# ---------------------------------------------------------------------------
# the catalogs that chip_smoke.py phase 37 holds against live servers
# ---------------------------------------------------------------------------

#: the words of the catalogs' "present" column (observability.md)
CONDITIONS = {"always", "--workers", "--online", "after a fold", "card", "after a build",
              "after an ANN query", "--wal-dir", "after ingest", "after a resilient call",
              "after a profiled train", "--stats"}


def _table(doc: str, header: str) -> list[list[str]]:
    lines = _read(doc).splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith(header))
    rows = []
    for line in lines[start + 2:]:
        if not line.startswith("|"):
            break
        rows.append([c.strip().strip("`") for c in line.strip().strip("|").split("|")])
    return rows


@pytest.mark.parametrize("doc, header, registered", [
    ("observability.md", "| family | type | server | present |", True),
    ("serving-performance.md", "| key | server | present |", False),
])
def test_catalogs_name_servers_and_conditions_phase_37_knows(doc, header, registered):
    rows = _table(doc, header)
    assert len(rows) >= 12
    families = _registered_families()
    for row in rows:
        servers = {s.strip() for s in row[-3].split(",")}
        assert servers <= {"engine", "event"} and servers, (doc, row)
        assert row[-2] in CONDITIONS, (doc, row)
        assert not registered or row[0] in families, (doc, row)
