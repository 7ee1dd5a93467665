"""Generate the markdown API reference for pyflyt_tpu's public surface.

The reference ships a Sphinx docs tree covering every public class
(/root/reference/docs_source/conf.py:1 and docs_source/ throughout); this
repo's equivalent is a dependency-free generator (sphinx/pdoc are not in
the image) that introspects the installed package and emits one markdown
page per module under docs/api/, plus an index.

Build target:
    JAX_PLATFORMS=cpu python docs/gen_api_docs.py

Conventions: a name is documented if it is public (no leading underscore)
and either listed in the module's __all__ or defined in that module.
Dataclass/flax.struct fields are listed with their declared types.
"""

from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import importlib  # noqa: E402
import inspect  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "pyflyt_tpu",
    "pyflyt_tpu.device",
    "pyflyt_tpu.core.aviary",
    "pyflyt_tpu.core.camera",
    "pyflyt_tpu.core.integrator",
    "pyflyt_tpu.core.load_objs",
    "pyflyt_tpu.core.math",
    "pyflyt_tpu.core.params",
    "pyflyt_tpu.core.state",
    "pyflyt_tpu.core.struct",
    "pyflyt_tpu.core.wind",
    "pyflyt_tpu.models.quadx",
    "pyflyt_tpu.models.fixedwing",
    "pyflyt_tpu.models.rocket",
    "pyflyt_tpu.ops.motors",
    "pyflyt_tpu.ops.boosters",
    "pyflyt_tpu.ops.boring_bodies",
    "pyflyt_tpu.ops.gimbals",
    "pyflyt_tpu.ops.lifting_surfaces",
    "pyflyt_tpu.ops.pid",
    "pyflyt_tpu.ops.ga_pid",
    "pyflyt_tpu.ops.pallas_quadx",
    "pyflyt_tpu.ops.pallas_fixedwing",
    "pyflyt_tpu.ops.pallas_rocket",
    "pyflyt_tpu.ops.pallas_dogfight",
    "pyflyt_tpu.ops.pallas_math",
    "pyflyt_tpu.envs.base",
    "pyflyt_tpu.envs.gym_wrapper",
    "pyflyt_tpu.envs.pz_wrapper",
    "pyflyt_tpu.envs.quadx_base",
    "pyflyt_tpu.envs.quadx_hover",
    "pyflyt_tpu.envs.quadx_waypoints",
    "pyflyt_tpu.envs.quadx_gates",
    "pyflyt_tpu.envs.fixedwing_base",
    "pyflyt_tpu.envs.fixedwing_waypoints",
    "pyflyt_tpu.envs.rocket_base",
    "pyflyt_tpu.envs.rocket_landing",
    "pyflyt_tpu.envs.ma_quadx_hover",
    "pyflyt_tpu.envs.ma_fixedwing_dogfight",
    "pyflyt_tpu.envs.packed_hover",
    "pyflyt_tpu.envs.packed_dogfight",
    "pyflyt_tpu.envs.selfplay_dogfight",
    "pyflyt_tpu.envs.quadx_mod.hovering",
    "pyflyt_tpu.envs.quadx_mod.packed_hovering",
    "pyflyt_tpu.envs.quadx_mod.trajectory_following_fast",
    "pyflyt_tpu.envs.quadx_mod.trajectory_following_slow",
    "pyflyt_tpu.envs.quadx_mod.pid_expert",
    "pyflyt_tpu.envs.utils.waypoints",
    "pyflyt_tpu.envs.utils.flatten_waypoints",
    "pyflyt_tpu.parallel.mesh",
    "pyflyt_tpu.rl.ppo",
    "pyflyt_tpu.rl.networks",
    "pyflyt_tpu.rl.train",
    "pyflyt_tpu.rl.checkpoint",
    "pyflyt_tpu.rl_training.hovering",
    "pyflyt_tpu.rl_training.trajectory_following",
    "pyflyt_tpu.rl_training.gates_vision",
    "pyflyt_tpu.rl_training.dogfight_selfplay",
    "pyflyt_tpu.utils.results",
    "pyflyt_tpu.utils.hovering_logger",
    "pyflyt_tpu.utils.trajectory_logger",
    "pyflyt_tpu.utils.telemetry",
    "pyflyt_tpu.utils.debug",
]

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api")


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else ""


def _is_public_member(mod, name, obj) -> bool:
    if name.startswith("_"):
        return False
    declared = getattr(mod, "__all__", None)
    if declared is not None:
        return name in declared
    return getattr(obj, "__module__", None) == mod.__name__


def _class_section(name: str, cls: type, lines: list[str]) -> None:
    lines.append(f"### class `{name}`\n")
    doc = _doc(cls)
    if doc:
        lines.append(doc + "\n")
    if dataclasses.is_dataclass(cls):
        fields = dataclasses.fields(cls)
        if fields:
            lines.append("**Fields**\n")
            lines.append("| field | type | default |")
            lines.append("|---|---|---|")
            for f in fields:
                t = f.type if isinstance(f.type, str) else getattr(
                    f.type, "__name__", str(f.type))
                if f.default is not dataclasses.MISSING:
                    dflt = repr(f.default)
                elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                    dflt = f"{getattr(f.default_factory, '__name__', 'factory')}()"
                else:
                    dflt = "—"
                dflt = dflt.replace("|", "\\|")
                lines.append(f"| `{f.name}` | `{t}` | `{dflt}` |")
            lines.append("")
    for mname, m in inspect.getmembers(cls):
        if mname.startswith("_"):
            continue
        if inspect.isfunction(m) or inspect.ismethod(m):
            if m.__qualname__.split(".")[0] != cls.__name__:
                continue  # inherited
            lines.append(f"#### `{name}.{mname}{_sig(m)}`\n")
            mdoc = _doc(m)
            if mdoc:
                lines.append(mdoc + "\n")
        elif isinstance(inspect.getattr_static(cls, mname, None), property):
            prop = inspect.getattr_static(cls, mname)
            lines.append(f"#### `{name}.{mname}` *(property)*\n")
            pdoc = _doc(prop)
            if pdoc:
                lines.append(pdoc + "\n")


def render_module(modname: str) -> tuple[str, str, str]:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`\n"]
    mdoc = _doc(mod)
    first_line = mdoc.splitlines()[0] if mdoc else ""
    if mdoc:
        lines.append(mdoc + "\n")

    classes, functions, constants = [], [], []
    for name, obj in vars(mod).items():
        if not _is_public_member(mod, name, obj):
            continue
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif inspect.isfunction(obj):
            functions.append((name, obj))
        elif isinstance(obj, (int, float, str, tuple)):
            constants.append((name, obj))

    if constants:
        lines.append("## Constants\n")
        for name, obj in constants:
            rep = repr(obj)
            if len(rep) > 120:
                rep = rep[:117] + "..."
            lines.append(f"- `{name} = {rep}`")
        lines.append("")
    if classes:
        lines.append("## Classes\n")
        for name, cls in classes:
            _class_section(name, cls, lines)
    if functions:
        lines.append("## Functions\n")
        for name, fn in functions:
            lines.append(f"### `{name}{_sig(fn)}`\n")
            fdoc = _doc(fn)
            if fdoc:
                lines.append(fdoc + "\n")

    fname = modname.replace(".", "_") + ".md"
    return fname, first_line, "\n".join(lines) + "\n"


def main() -> None:
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    index = [
        "# pyflyt_tpu API reference\n",
        "Generated by `python docs/gen_api_docs.py` — regenerate after any",
        "public-surface change. One page per module; see",
        "[MIGRATION.md](../MIGRATION.md) for the reference-surface mapping.\n",
        "| module | summary |",
        "|---|---|",
    ]
    for modname in MODULES:
        fname, summary, text = render_module(modname)
        with open(os.path.join(OUT_DIR, fname), "w") as f:
            f.write(text)
        index.append(f"| [`{modname}`]({fname}) | {summary} |")
        print("wrote", fname)
    with open(os.path.join(OUT_DIR, "README.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote README.md (index of", len(MODULES), "modules)")


if __name__ == "__main__":
    main()
