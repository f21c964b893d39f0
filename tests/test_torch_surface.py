"""The port's public surface against the JAX package's, read with ``ast``.

Every module of ``gpsat_tpu`` is parsed (never imported: this file imports
no JAX) and each public name it defines must resolve at the same path under
``gpsat_tpu_torch``: top-level functions and classes, module constants,
class methods (also those attached after the class, ``Cls.name = fn``), and
the names a module re-exports (an import marked ``# noqa: F401`` or listed
in ``__all__``). Each public function's and method's parameter names must
be parameters of its counterpart. ``EXCEPTIONS`` lists, with its reason,
every path that is left out on purpose.
"""

import ast
import importlib
import importlib.util
import inspect
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "gpsat_tpu"

# dotted path (a module, "module.name", or "module.function:parameter") -> why
EXCEPTIONS = {
    "gpsat_tpu.ops.pallas": "the three Pallas TPU kernels; replaced by the CUDA kernels bound in "
                            "gpsat_tpu_torch/ops/{block_chol,panel_chol,cholesky}.py",
    "gpsat_tpu.enable_x64": "a JAX switch (jax_enable_x64); torch takes the dtype per tensor",
    "gpsat_tpu.enable_compilation_cache": "a JAX switch (the persistent XLA compilation cache); the port "
                                          "compiles nothing at run time but its libraries, cached in build/",
    "gpsat_tpu.ops.kernels.Array": "the type alias jnp.ndarray",
    "gpsat_tpu.ops.linalg.Array": "the type alias jnp.ndarray",
    "gpsat_tpu.ops.transforms.Array": "the type alias jnp.ndarray",
    "gpsat_tpu.ops.linalg.set_fast_inverse": "a trace-time switch; the port routes by the factor= argument",
    "gpsat_tpu.ops.linalg.use_fast_inverse": "a trace-time switch; the port routes by the factor= argument",
    "gpsat_tpu.ops.linalg.block_path_enabled": "a trace-time switch; the port routes by the factor= argument",
    "gpsat_tpu.ops.linalg.panel_path_enabled": "a trace-time switch; the port routes by the factor= argument",
    "gpsat_tpu.ops.linalg.recursive_path_enabled": "a trace-time switch; the port routes by the factor= argument",
    "gpsat_tpu.ops.linalg.recursive_pair_enabled": "a trace-time switch; the port routes by the factor= argument",
    "gpsat_tpu.ops.linalg.chol_blocking": "a trace-time switch; the port routes by the factor= argument",
    "gpsat_tpu.ops.linalg.chol_panel_pair": "a trace-time switch; the port routes by the factor= argument",
    "gpsat_tpu.utils.flops.V5E_BF16_PEAK_TFLOPS": "a TPU v5e peak; the port's peaks are the H100's",
    "gpsat_tpu.utils.flops.V5E_F32_HIGHEST_TFLOPS": "a TPU v5e peak; the port's peaks are the H100's",
    "gpsat_tpu.distributed.init_distributed:local_device_ids": "JAX's device assignment of a process; a port "
                                                               "process takes the card of its local rank",
    "gpsat_tpu.distributed.dryrun_multiprocess:devices_per_process": "XLA's fake host-device count; the port's "
                                                                     "CPU processes take shards=",
    "gpsat_tpu.ops.linalg.chol_winv_recursive:K": "the port's ops.linalg re-exports recursive_chol's function, "
                                                  "whose argument is A in both packages",
    "gpsat_tpu.models.asvgp.ASVGPModel.set_kernel_variance:v": "the port's ASVGPModel inherits the base "
                                                               "class's setter (kernel_variance, as every "
                                                               "other JAX class names it)",
    "gpsat_tpu.models.asvgp.ASVGPModel.set_likelihood_variance:v": "the port's ASVGPModel inherits the base "
                                                                   "class's setter (likelihood_variance, as "
                                                                   "every other JAX class names it)",
}


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(REPO).with_suffix("").parts)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _excepted(path: str) -> bool:
    return any(path == e or path.startswith(e + ".") for e in EXCEPTIONS)


ALL_MODULES = sorted(_module_name(p) for p in JAX_PKG.rglob("*.py") if p.name != "__main__.py")
MODULES = [m for m in ALL_MODULES if not _excepted(m)]


def _public(name: str) -> bool:
    return not name.startswith("_")


def _dunder_all(tree: ast.Module) -> set:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return {e.value for e in node.value.elts if isinstance(e, ast.Constant)}
    return set()


def _is_property(decorator) -> bool:
    # @property, @name.setter, @functools.cached_property: no call signature
    name = decorator.attr if isinstance(decorator, ast.Attribute) else getattr(decorator, "id", "")
    return name in ("property", "setter", "getter", "deleter", "cached_property")


def surface(module: str):
    """(names, functions) of one JAX module: every public name it defines,
    re-exports or attaches to a class ("Cls.name"), and the public
    functions and methods with their parameter names."""
    source = (JAX_PKG.parent / (module.replace(".", "/"))).with_suffix(".py")
    if not source.exists():
        source = JAX_PKG.parent / module.replace(".", "/") / "__init__.py"
    text = source.read_text()
    lines = text.splitlines()
    tree = ast.parse(text)
    exported = _dunder_all(tree)
    names, functions = [], {}

    def params(fn):
        a = fn.args
        return [x.arg for x in a.args + a.kwonlyargs if x.arg not in ("self", "cls")]

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and _public(node.name):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(sub.name):
                        names.append(f"{node.name}.{sub.name}")
                        if not any(_is_property(d) for d in sub.decorator_list):
                            functions[f"{node.name}.{sub.name}"] = params(sub)
            else:
                functions[node.name] = params(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(t, ast.Name) and _public(t.id):
                    names.append(t.id)
                elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) and _public(t.attr):
                    names.append(f"{t.value.id}.{t.attr}")
        elif isinstance(node, ast.ImportFrom):
            # the mark on the statement's first line covers every name it
            # imports; on a later line, the name on that line
            block = "noqa: F401" in lines[node.lineno - 1]
            for alias in node.names:
                name = alias.asname or alias.name
                marked = block or "noqa: F401" in lines[alias.lineno - 1]
                if _public(name) and (marked or name in exported):
                    names.append(name)
    return names, functions


def _resolve(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("module", MODULES)
def test_names_resolve_in_the_port(module):
    port = importlib.import_module(module.replace("gpsat_tpu", "gpsat_tpu_torch", 1))
    names, functions = surface(module)
    missing = [n for n in names if not _excepted(f"{module}.{n}") and not hasattr(_resolve(port, n.rsplit(".", 1)[0])
                                                                                 if "." in n else port,
                                                                                 n.rsplit(".", 1)[-1])]
    assert not missing, f"{module}: not in the port: {missing}"
    renamed = {}
    for name, want in functions.items():
        if _excepted(f"{module}.{name}"):
            continue
        have = inspect.signature(_resolve(port, name)).parameters
        lost = [p for p in want if p not in have and f"{module}.{name}:{p}" not in EXCEPTIONS]
        if lost:
            renamed[name] = lost
    assert not renamed, f"{module}: parameters missing in the port: {renamed}"


def test_exceptions_are_still_needed():
    # an exception whose name has come to resolve in the port (or has gone
    # from the JAX package) is stale
    stale = []
    for path, _ in EXCEPTIONS.items():
        path, _, param = path.partition(":")
        if any(m == path or m.startswith(path + ".") for m in ALL_MODULES):  # a module or a package
            if importlib.util.find_spec(path.replace("gpsat_tpu", "gpsat_tpu_torch", 1)) is not None:
                stale.append(path)
            continue
        module = max((m for m in ALL_MODULES if path.startswith(m + ".")), key=len)
        name = path[len(module) + 1:]
        names, functions = surface(module)
        port = importlib.import_module(module.replace("gpsat_tpu", "gpsat_tpu_torch", 1))
        if param:
            if param not in functions.get(name, []) or param in inspect.signature(_resolve(port, name)).parameters:
                stale.append(f"{path}:{param}")
        elif name not in names or hasattr(port, name):
            stale.append(path)
    assert not stale, f"exceptions that no longer apply: {stale}"
