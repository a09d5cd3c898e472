"""The port's public surface covers ``eqvio_tpu``'s, name by name.

Both packages are read as source with ``ast`` (nothing is imported, so this
needs neither JAX nor CUDA). For every module of ``eqvio_tpu`` the mirrored
module of ``eqvio_tpu_torch`` must define each public top-level function and
class, each ``__all__`` entry and each name an ``__init__.py`` re-exports, each
public method of each class (``__init__`` and other dunders included; a
class-level alias such as ``get_imu_batch = get_imu`` counts), each other
public name a class body binds (an alias such as ``close = flush``, a
``NamedTuple`` field), each parameter name of each public function and
method, and each command-line option an ``argparse`` parser adds. The port
may add names and parameters. Private names (``_x``) are not audited.
Every remaining difference is an entry of ``ALLOWED`` with its reason.

The repository's root programs ``bench.py`` and ``bench_kernels.py`` are
held the same way to their counterparts in the port: every top-level
function (private ones too), its parameters and every upper-case constant,
with the renames in ``ROOT_RENAMED``.

A second test holds the port's device policy: no public function or method
defaults ``device`` to the CPU.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "eqvio_tpu")
PORT_ROOT = os.path.join(REPO, "eqvio_tpu_torch")

# module path -> reason (the whole module has no mirror), or
# "module:qualname" -> {parameter: reason} for parameters the port does not take.
ALLOWED = {
    "frontend/pallas_klt.py": "the TPU kernel; its counterpart is kernels/klt.py with csrc/klt_cuda.cu",
    "app/_env.py": "TPU runtime set-up; its counterpart is runtime.configure_runtime",
    "frontend/klt.py:track_features": {
        "use_pallas": "a TPU route; the port has one route: the CUDA kernel on the card, gathers on the CPU",
        "mode": "a TPU route; the port has one route: the CUDA kernel on the card, gathers on the CPU",
    },
    "frontend/tracker.py:tracker_init": {
        "dtype": "replaced by device: the tracker is float32 in both packages",
    },
    "app/run_opt.py:run_dataset": {
        "dataset_dir": "replaced by dataset, which takes a directory, a bag or a reader",
    },
    "app/run_opt.py:collect_fused_inputs": {
        "dataset_dir": "replaced by dataset, which takes a directory, a bag or a reader",
    },
    "app/run_opt.py:bench_batch_full_frame": {
        "dataset_dir": "replaced by dataset, which takes a directory, a bag or a reader",
    },
    "frontend/tracker.py:TrackerConfig": {
        "use_pallas": "selects a TPU route of track_features, which the port does not have",
        "klt_mode": "selects a TPU route of track_features, which the port does not have",
    },
    "filter.py:predict_state": {
        "stamp": "unused in the JAX body",
    },
}


def _modules():
    out = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for name in files:
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, name), JAX_ROOT).replace(os.sep, "/"))
    return sorted(out)


def _parse(root, rel):
    with open(os.path.join(root, rel)) as f:
        return ast.parse(f.read(), rel)


def _top_level(body):
    """Statements at module level, including those under ``if`` and ``try``."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            for block in (node.body, node.orelse, node.finalbody, *(h.body for h in node.handlers)):
                yield from _top_level(block)
        else:
            yield node


def _bound_names(node):
    """Names a statement binds in its scope."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return [node.name]
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return [(a.asname or a.name).split(".")[0] for a in node.names]
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    names = []
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                names.append(sub.id)
    return names


def _all_entries(tree):
    for node in _top_level(tree.body):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return []


def _params(fn):
    a = fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    return names, (a.vararg.arg if a.vararg else None), (a.kwarg.arg if a.kwarg else None)


def _public(name):
    return not name.startswith("_") or (name.startswith("__") and name.endswith("__"))


class _Module:
    """One module's public functions, classes and bound names."""

    def __init__(self, tree):
        self.tree = tree
        self.names = set()
        self.functions = {}
        self.classes = {}
        for node in _top_level(tree.body):
            self.names.update(_bound_names(node))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node

    def members(self, cls):
        """A class's methods (by name) and every name its body binds."""
        methods, names = {}, set()
        for node in _top_level(cls.body):
            names.update(_bound_names(node))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[node.name] = node
        return methods, names


def _forwarded_params(port, fn, kwarg):
    """Parameters a ``**kwarg`` of ``fn`` reaches: those of every function or
    class of the same module that ``fn`` calls with ``**kwarg``."""
    found = set()
    for call in ast.walk(fn):
        if not isinstance(call, ast.Call) or not isinstance(call.func, ast.Name):
            continue
        if not any(k.arg is None and isinstance(k.value, ast.Name) and k.value.id == kwarg for k in call.keywords):
            continue
        callee = call.func.id
        if callee in port.functions:
            found.update(_params(port.functions[callee])[0])
        elif callee in port.classes:
            methods, names = port.members(port.classes[callee])
            if "__init__" in methods:
                found.update(_params(methods["__init__"])[0])
            found.update(names)  # NamedTuple and dataclass fields
    return found


def _missing_params(rel, qualname, jax_fn, port, port_fn):
    jax_names, jax_var, jax_kw = _params(jax_fn)
    port_names, port_var, port_kw = _params(port_fn)
    allowed = ALLOWED.get(f"{rel}:{qualname}", {})
    have = set(port_names)
    if port_kw is not None:
        have |= _forwarded_params(port, port_fn, port_kw)
    missing = [p for p in jax_names if p not in have and p not in allowed]
    if jax_var is not None and port_var is None and jax_var not in allowed:
        missing.append("*" + jax_var)
    if jax_kw is not None and port_kw is None and jax_kw not in allowed:
        missing.append("**" + jax_kw)
    return [f"{qualname}({p})" for p in missing]


def _cli_options(tree):
    """The option strings of every ``add_argument`` call in a module."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "add_argument":
            out.update(a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str))
    return out


def surface_gaps(rel, port_tree=None):
    """What ``eqvio_tpu/<rel>`` offers publicly and the port's mirror (its
    file, or ``port_tree``) lacks."""
    if port_tree is None:
        if not os.path.exists(os.path.join(PORT_ROOT, rel)):
            return [f"module {rel}"]
        port_tree = _parse(PORT_ROOT, rel)
    jax, port = _Module(_parse(JAX_ROOT, rel)), _Module(port_tree)
    wanted = set(_all_entries(jax.tree))
    if rel.endswith("__init__.py"):
        for node in _top_level(jax.tree.body):
            if isinstance(node, ast.ImportFrom):
                wanted.update(a.asname or a.name for a in node.names)
    wanted.update(n for n in (*jax.functions, *jax.classes) if not n.startswith("_"))
    gaps = [f"name {n}" for n in sorted(wanted - port.names)]
    gaps += [f"option {o}" for o in sorted(_cli_options(jax.tree) - _cli_options(port.tree))]
    for name, fn in sorted(jax.functions.items()):
        if not name.startswith("_") and name in port.functions:
            gaps += _missing_params(rel, name, fn, port, port.functions[name])
    for name, cls in sorted(jax.classes.items()):
        if name.startswith("_") or name not in port.classes:
            continue
        jax_methods, jax_names = jax.members(cls)
        port_methods, port_names = port.members(port.classes[name])
        allowed = ALLOWED.get(f"{rel}:{name}", {})
        for member in sorted(jax_names):
            if _public(member) and member not in port_names and member not in allowed:
                gaps.append(f"member {name}.{member}")
        for meth, fn in sorted(jax_methods.items()):
            if _public(meth) and meth in port_methods:
                gaps += _missing_params(rel, f"{name}.{meth}", fn, port, port_methods[meth])
    return gaps


@pytest.mark.parametrize("rel", _modules())
def test_port_mirrors_public_surface(rel):
    if isinstance(ALLOWED.get(rel), str):
        assert os.path.exists(os.path.join(JAX_ROOT, rel))
        assert not os.path.exists(os.path.join(PORT_ROOT, rel))
        return
    assert surface_gaps(rel) == []


def test_allowlist_names_what_exists():
    """Every allowlist entry names a JAX module, function, method or class
    member that exists, and the port really lacks it."""
    for key, value in ALLOWED.items():
        rel, _, qualname = key.partition(":")
        jax = _Module(_parse(JAX_ROOT, rel))
        if not qualname:
            assert isinstance(value, str), key
            continue
        head, _, meth = qualname.partition(".")
        if head in jax.functions:
            jax_names = set(_params(jax.functions[head])[0])
        else:
            methods, jax_names = jax.members(jax.classes[head])
            if meth:
                jax_names = set(_params(methods[meth])[0])
        assert set(value) <= jax_names, key
        port = _Module(_parse(PORT_ROOT, rel))
        if head in port.functions:
            port_names = set(_params(port.functions[head])[0])
        else:
            methods, port_names = port.members(port.classes[head])
            if meth:
                port_names = set(_params(methods[meth])[0])
        assert not set(value) & port_names, key


def _drop(source, old, new=""):
    assert source.count(old) == 1, old
    return source.replace(old, new)


# each case removes one public item from a copy of the port's source
MUTATIONS = {
    "function": ("lie.py", lambda s: _drop(s, "def sot3_apply(", "def sot3_apply_gone("), "name sot3_apply"),
    "class": ("sim.py", lambda s: _drop(s, "class Simulator(", "class SimulatorGone("), "name Simulator"),
    "reexport": ("data/__init__.py", lambda s: _drop(s, "    generate_racing_proxy,\n"),
                 "name generate_racing_proxy"),
    "method": ("data/asl.py", lambda s: _drop(s, "def load_image(", "def load_image_gone("),
               "member ASLDatasetReader.load_image"),
    "class_alias": ("io/writer.py", lambda s: _drop(s, "    close = flush\n"), "member VIOWriter.close"),
    "property": ("lie.py", lambda s: _drop(s, "def batch_shape(self)", "def batch_shape_gone(self)"),
                 "member SE3.batch_shape"),
    "field": ("states.py", lambda s: _drop(s, "    gyr_bias_vel: torch.Tensor  # [..., 3]\n"),
              "member IMU.gyr_bias_vel"),
    "parameter": ("states.py", lambda s: _drop(s, "device, batch_shape=()) -> VIOSensorState",
                                              "device) -> VIOSensorState"),
                  "sensor_identity(batch_shape)"),
    "method_parameter": ("checkpoint.py", lambda s: _drop(s, "cursor: dict | None = None, rng_key=None)",
                                                          "cursor: dict | None = None)"),
                         "save_checkpoint(rng_key)"),
    "option": ("app/run_opt.py", lambda s: _drop(s, '"--display"', '"--display-gone"'), "option --display"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_surface_check_sees_a_removal(case):
    """The audit reports each kind of public item once it is gone."""
    rel, mutate, gap = MUTATIONS[case]
    with open(os.path.join(PORT_ROOT, rel)) as f:
        source = f.read()
    assert gap not in surface_gaps(rel, ast.parse(source))
    assert gap in surface_gaps(rel, ast.parse(mutate(source)))


# the repository's programs at its root and their counterparts in the port;
# "program:function" -> (the port's name, reason) for a function it renames
ROOT_PAIRS = {"bench.py": "bench.py", "bench_kernels.py": "bench_kernels.py"}
ROOT_RENAMED = {
    "bench.py:_pallas_tracker_gate": ("_klt_gate", "the gate holds the CUDA KLT kernel, not the Pallas one, "
                                                   "to its plain version"),
}


def root_gaps(program, port_tree=None):
    """What the root program ``program`` defines and its port (its file, or
    ``port_tree``) lacks: every top-level function, private ones included,
    each of their parameters, and every upper-case module constant."""
    jax = _Module(_parse(REPO, program))
    port = _Module(port_tree if port_tree is not None else _parse(PORT_ROOT, ROOT_PAIRS[program]))
    gaps = [f"name {n}" for n in sorted(jax.names - port.names) if n.isupper()]
    for name, fn in sorted(jax.functions.items()):
        mine = ROOT_RENAMED.get(f"{program}:{name}", (name,))[0]
        if mine not in port.functions:
            gaps.append(f"name {name}")
        else:
            gaps += _missing_params(program, name, fn, port, port.functions[mine])
    return gaps


@pytest.mark.parametrize("program", sorted(ROOT_PAIRS))
def test_port_mirrors_root_program(program):
    assert root_gaps(program) == []
    for key, (mine, _) in ROOT_RENAMED.items():
        rel, _, name = key.partition(":")
        assert name in _Module(_parse(REPO, rel)).functions and mine in _Module(_parse(PORT_ROOT, rel)).functions


ROOT_MUTATIONS = {
    "function": ("bench.py", "def _prior_round_best(", "def _prior_round_best_gone(", "name _prior_round_best"),
    "renamed": ("bench.py", "def _klt_gate(", "def _klt_gate_gone(", "name _pallas_tracker_gate"),
    "parameter": ("bench_kernels.py", "def _time(f, *args, reps=50)", "def _time(f, *args)", "_time(reps)"),
    "constant": ("bench.py", "\nREFERENCE_FPS = ", "\nREFERENCE_FPS_GONE = ", "name REFERENCE_FPS"),
}


@pytest.mark.parametrize("case", sorted(ROOT_MUTATIONS))
def test_root_check_sees_a_removal(case):
    """The root programs' audit reports a function, renamed function,
    parameter or constant once it is gone from the port."""
    program, old, new, gap = ROOT_MUTATIONS[case]
    with open(os.path.join(PORT_ROOT, ROOT_PAIRS[program])) as f:
        source = f.read()
    assert gap not in root_gaps(program, ast.parse(source))
    assert gap in root_gaps(program, ast.parse(_drop(source, old, new)))


def _defaults(fn):
    a = fn.args
    pos = [*a.posonlyargs, *a.args]
    pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
    return {arg.arg: default for arg, default in pairs if default is not None}


def _is_cpu(node):
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and ast.unparse(node.func) in ("torch.device", "device")
            and any(_is_cpu(a) for a in node.args))


def _public_functions(tree):
    """``(qualname, node)`` of every public module-level function and every
    public method of a public class."""
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            yield node.name, node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in _top_level(node.body):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(sub.name):
                    yield f"{node.name}.{sub.name}", sub


def _port_modules():
    out = []
    for dirpath, _, files in os.walk(PORT_ROOT):
        for name in files:
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, name), PORT_ROOT).replace(os.sep, "/"))
    return sorted(out)


def test_no_public_entry_defaults_to_the_cpu():
    """The port runs on the card unless the caller asks for the CPU: no
    public function or method gives its ``device`` parameter a CPU default.
    (An op's ``device_types="cpu"`` registration is no parameter default.)"""
    seen, bad = [], []
    for rel in _port_modules():
        for qualname, fn in _public_functions(_parse(PORT_ROOT, rel)):
            if "device" not in _params(fn)[0]:
                continue
            seen.append(f"{rel}:{qualname}")
            default = _defaults(fn).get("device")
            if default is not None and _is_cpu(default):
                bad.append(f"{rel}:{qualname}")
    assert len(seen) >= 30, seen
    assert bad == []
