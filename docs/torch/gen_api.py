"""API reference of the PyTorch port ``pygradflow_torch``: the generator of
``docs/gen_api.py`` with its surface mapped module for module to the port.

One markdown page per public module, built from live signatures and
docstrings via ``inspect``, plus an index.  The output is deterministic:
no default in the surface's signatures is a function, an object or a
``torch.device``, whose ``repr`` would hold a memory address or the
machine's device (``tests/test_torch_docs.py`` checks that no page holds
an address).  The test regenerates into a temp dir and asserts that the
committed ``docs/torch/api/`` tree matches.

Usage: python docs/torch/gen_api.py [outdir]   (default docs/torch/api)
"""

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

# (module, [public names]) — the user-facing surface, in reading order.
SURFACE = [
    (
        "pygradflow_torch",
        [
            "Problem",
            "FuncProblem",
            "QuadraticProblem",
            "Params",
            "Solver",
            "SolverResult",
            "SolverStatus",
            "Scaling",
        ],
    ),
    (
        "pygradflow_torch.params",
        [
            "Precision",
            "NewtonType",
            "StepSolverType",
            "StepControlType",
            "PenaltyUpdate",
            "LinearSolverType",
            "ScalingType",
            "IntegrationMethod",
        ],
    ),
    (
        "pygradflow_torch.integration",
        [
            "IntegrationSolver",
            "BatchedIntegrationSolver",
            "ShardedIntegrationSolver",
        ],
    ),
    (
        "pygradflow_torch.parallel",
        [
            "BatchedSolver",
            "BatchResult",
            "ShardedSolver",
            "DistributedSolver",
            "MixedPrecisionSolver",
            "multistart_solve",
        ],
    ),
    (
        "pygradflow_torch.parallel.batch",
        ["ParametricProblem"],
    ),
    (
        "pygradflow_torch.linalg",
        ["linear_solver", "LinearSolver", "LinearSolverError"],
    ),
    (
        "pygradflow_torch.checkpoint",
        ["save_state", "load_state", "CheckpointManager"],
    ),
    (
        "pygradflow_torch.callbacks",
        ["Callbacks", "CallbackType"],
    ),
    (
        "pygradflow_torch.deriv_check",
        ["deriv_check", "deriv_check_problem", "DerivError"],
    ),
    (
        "pygradflow_torch.runners.runner",
        ["Runner"],
    ),
    (
        "pygradflow_torch.runners.instance",
        ["Instance"],
    ),
]


def _clean_doc(obj):
    doc = inspect.getdoc(obj)
    return doc.strip() if doc else "*(undocumented)*"


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _member_section(name, obj):
    lines = []
    if inspect.isclass(obj):
        lines.append(f"### class `{name}{_signature(obj)}`\n")
        lines.append(_clean_doc(obj) + "\n")
        for mname, member in sorted(vars(obj).items()):
            if mname.startswith("_") and mname != "__init__":
                continue
            if inspect.isfunction(member):
                lines.append(f"#### `{name}.{mname}{_signature(member)}`\n")
                lines.append(_clean_doc(member) + "\n")
            elif isinstance(member, property):
                lines.append(f"#### property `{name}.{mname}`\n")
                lines.append(_clean_doc(member) + "\n")
        # enums: list the values
        import enum

        if isinstance(obj, type) and issubclass(obj, enum.Enum):
            lines.append("Values: " + ", ".join(f"`{v.name}`" for v in obj) + "\n")
    elif callable(obj):
        lines.append(f"### `{name}{_signature(obj)}`\n")
        lines.append(_clean_doc(obj) + "\n")
    else:
        lines.append(f"### `{name}`\n")
        lines.append(_clean_doc(obj) + "\n")
    return "\n".join(lines)


def generate(outdir):
    os.makedirs(outdir, exist_ok=True)
    index = [
        "# pygradflow-torch API reference\n",
        "Generated by `docs/torch/gen_api.py` from live docstrings "
        "(`tests/test_torch_docs.py` keeps it in sync).  Start with "
        "[MIGRATING.md](../MIGRATING.md) and the examples in `docs/torch/`.\n",
    ]
    for module_name, names in SURFACE:
        mod = importlib.import_module(module_name)
        fname = module_name.replace(".", "_") + ".md"
        parts = [f"# `{module_name}`\n", _clean_doc(mod) + "\n"]
        for name in names:
            parts.append(_member_section(name, getattr(mod, name)))
        with open(os.path.join(outdir, fname), "w") as f:
            f.write("\n".join(parts))
        index.append(
            f"- [`{module_name}`]({fname}) — "
            + ", ".join(f"`{n}`" for n in names)
        )
    with open(os.path.join(outdir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")


if __name__ == "__main__":
    generate(sys.argv[1] if len(sys.argv) > 1 else
             os.path.join(os.path.dirname(os.path.abspath(__file__)), "api"))
