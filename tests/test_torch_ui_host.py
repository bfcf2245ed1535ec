"""The port's host UI modules against the JAX package's, on the CPU:

  * the host copies (ui/ tool, actions, widgets, panel, radial_menu,
    text_input, landing and the package's __init__; storage/; the texture
    import path: models/quantize.py, texture/) are the JAX package's
    source, line for line, below their module docstrings (their relative
    imports resolve to the port's own modules, so text_input and landing
    paint through the port's ops/draw2d);
  * `bonnie32_tpu_torch.ui` exports the names the JAX package's ui
    exports, each of the same kind;
  * tools (ui/tool.py): a seeded run of activations, deactivations,
    toggles, enable/disable and deactivate_all on a ToolBox with exclusive
    groups and suppression: after every call the modal stack, the
    suppressed set and each tool's active flag and activation counts
    equal; InputState, ModifierKeys, MouseButtons and ToolController's
    defaults equal;
  * actions (ui/actions.py): the modeler's, editor's and tracker's
    registries (ids, labels, tips, categories, icons, shortcuts and their
    display strings, tooltips), then for seeded contexts (keys,
    modifiers, flags, undo/redo, text editing) the triggered ids and every
    action's enabled and checked flags; rebinding, its conflict error and
    reset_shortcut.

Tolerance: none; everything compared is host data.
"""

import ast
import pathlib
import random
import re

import pytest

import torch_ui_cases as uc
from bonnie32_tpu import ui as jui
from bonnie32_tpu.ui import actions as jact
from bonnie32_tpu.ui import tool as jtool
from bonnie32_tpu_torch import ui as tui
from bonnie32_tpu_torch.ui import actions as tact
from bonnie32_tpu_torch.ui import tool as ttool

REPO = pathlib.Path(__file__).resolve().parent.parent
HOST_COPIES = ("ui/__init__.py", "ui/tool.py", "ui/actions.py",
               "ui/widgets.py", "ui/panel.py", "ui/radial_menu.py",
               "ui/text_input.py", "ui/landing.py", "storage/__init__.py",
               "storage/core.py", "storage/local.py", "storage/async_ops.py",
               "storage/cloud.py", "models/quantize.py",
               "texture/__init__.py", "texture/paint.py",
               "texture/import_image.py")


def _below_docstring(path):
    text = path.read_text()
    doc = ast.parse(text).body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
    return text.splitlines()[doc.end_lineno:]


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copy_is_the_jax_source(rel):
    ours = _below_docstring(REPO / "bonnie32_tpu_torch" / rel)
    theirs = _below_docstring(REPO / "bonnie32_tpu" / rel)
    assert ours == theirs
    assert not any(line.lstrip().startswith(("import jax", "from jax"))
                   for line in ours)


def test_ui_exports_match():
    assert tui.__all__ == jui.__all__
    for name in tui.__all__:
        a, b = getattr(tui, name), getattr(jui, name)
        assert type(a).__name__ == type(b).__name__, name
        if hasattr(b, "__name__"):          # classes, functions, modules
            assert (a.__name__.rsplit(".", 1)[-1]
                    == b.__name__.rsplit(".", 1)[-1]), name
        else:
            assert uc.plain(a) == uc.plain(b), name


# ---------------------------------------------------------------------------
# Tools
# ---------------------------------------------------------------------------

TOOL_IDS = ("select", "move", "rotate", "scale", "camera", "gizmo", "paint")


def _tool_run(tool_mod, seed, steps=120):
    class CountingTool(tool_mod.Tool):
        def __init__(self, tool_id):
            super().__init__(tool_id, tool_id.title())
            self.activate_count = 0
            self.deactivate_count = 0

        def do_activate(self):
            self.activate_count += 1
            return super().do_activate()

        def do_deactivate(self):
            self.deactivate_count += 1
            return super().do_deactivate()

    reg = tool_mod.ToolRegistry([CountingTool(i) for i in TOOL_IDS])
    box = tool_mod.ToolBox()
    box.add_exclusive_group(["select", "move", "rotate", "scale"])
    box.add_exclusive_group(["paint", "select"])
    box.add_exclusive_group(["gizmo"])                  # one tool: ignored
    box.suppress_while_active("camera", ["gizmo", "paint"])
    box.suppress_while_active("rotate", ["gizmo"])
    rng = random.Random(seed)
    trace = [reg.tool_ids()]
    for _ in range(steps):
        op = rng.choice(("activate",) * 4 + ("deactivate", "toggle",
                                              "toggle", "all", "enable",
                                              "enable", "disable"))
        tid = rng.choice(TOOL_IDS + ("missing",))
        if op == "activate":
            box.activate_tool(tid, reg)
        elif op == "deactivate":
            box.deactivate_tool(tid, reg)
        elif op == "toggle":
            box.toggle_tool(tid, reg)
        elif op == "all":
            box.deactivate_all(reg)
        elif op == "enable":
            box.enable()
        else:
            box.disable()
        trace.append((op, tid, list(box.modal_tool_stack),
                      box.active_tool(), box.enabled(),
                      sorted(box._suppressed_tools),
                      [box.is_tool_suppressed(i) for i in TOOL_IDS],
                      [(t.active(), t.activate_count, t.deactivate_count,
                        t.label)
                       for t in (reg.get_tool(i) for i in TOOL_IDS)]))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_toolbox_run_matches_jax(seed):
    ours, theirs = _tool_run(ttool, seed), _tool_run(jtool, seed)
    assert ours == theirs
    assert any(len(t[2]) > 1 for t in ours[1:])        # stacks grew
    assert any(any(t[6]) for t in ours[1:])            # tools suppressed


def test_tool_input_types_match_jax():
    for mod in (ttool, jtool):
        assert mod.DragAcceptResult.NONE.value == "none"
    for kw in ({}, dict(mouse_x=100.0, mouse_y=200.0, mouse_dx=5.0,
                        mouse_dy=-3.0, scroll=1.5, double_click=True)):
        for mods in ({}, dict(shift=True), dict(ctrl=True, alt=True)):
            a = ttool.InputState(modifiers=ttool.ModifierKeys(**mods),
                                 buttons=ttool.MouseButtons(left=True), **kw)
            b = jtool.InputState(modifiers=jtool.ModifierKeys(**mods),
                                 buttons=jtool.MouseButtons(left=True), **kw)
            assert (a.mouse_pos(), a.mouse_delta(), a.has_modifier()) == \
                (b.mouse_pos(), b.mouse_delta(), b.has_modifier())
            assert uc.plain(a) == uc.plain(b)

    def defaults(mod):
        class Probe(mod.ToolController):
            pass
        t, inp = Probe("probe"), mod.InputState()
        return (t.mouse_click(inp), t.mouse_double_click(inp),
                t.mouse_move(inp), t.mouse_scroll(inp),
                t.accept_mouse_drag(inp).value,
                t.modifier_key_change(inp), t.cancel(), t.activate(),
                t.active(), t.deactivate(), t.active())
    assert defaults(ttool) == defaults(jtool)


# ---------------------------------------------------------------------------
# Actions
# ---------------------------------------------------------------------------

FACTORIES = ("create_modeler_actions", "create_editor_actions",
             "create_tracker_actions")


def _flags(mod):
    src = pathlib.Path(mod.__file__).read_text()
    found = set(re.findall(r'(?:_flag|has_flag)\("(\w+)"\)', src))
    return sorted(found | set(mod.EDITOR_FLAGS))


def _registry_view(reg):
    return [(a.id, a.label, a.status_tip, a.category, a.icon,
             uc.plain(a.default_shortcut), uc.plain(a.shortcut),
             a.shortcut.display() if a.shortcut else None, a.tooltip(),
             a.checked_fn is not None)
            for a in reg.actions.values()]


def _contexts(mod, reg, seed, n=300):
    keys = sorted({a.shortcut.key_name for a in reg.actions.values()
                   if a.shortcut is not None})
    flags = _flags(mod)
    rng = random.Random(seed)
    for _ in range(n):
        ctx = mod.ActionContext(
            pressed_keys=set(rng.sample(keys, rng.choice((0, 1, 1, 2)))),
            ctrl=rng.random() < 0.4, shift=rng.random() < 0.3,
            alt=rng.random() < 0.1, text_editing=rng.random() < 0.05,
            can_undo=rng.random() < 0.5, can_redo=rng.random() < 0.5,
            has_selection=rng.random() < 0.5,
            has_clipboard=rng.random() < 0.5)
        for f in rng.sample(flags, rng.randint(0, len(flags))):
            ctx.with_flag(f)
        yield ctx


def _dispatch(mod, factory, seed):
    reg = getattr(mod, factory)()
    out = [_registry_view(reg), sorted(reg.by_category()),
           {k: [a.id for a in v] for k, v in reg.by_category().items()}]
    for ctx in _contexts(mod, reg, seed):
        out.append((reg.triggered_ids(ctx),
                    [(reg.is_enabled(a, ctx), reg.is_checked(a, ctx),
                      reg.triggered(a, ctx)) for a in reg.actions],
                    reg.triggered("no.such.action", ctx)))
    return out


@pytest.mark.parametrize("factory", FACTORIES)
def test_action_registry_matches_jax(factory):
    ours, theirs = _dispatch(tact, factory, 7), _dispatch(jact, factory, 7)
    assert ours == theirs
    assert sum(1 for r in ours[3:] if r[0]) > 20       # actions fired
    assert _flags(tact) == _flags(jact)


@pytest.mark.parametrize("factory", FACTORIES)
def test_rebind_matches_jax(factory):
    def run(mod):
        reg = getattr(mod, factory)()
        ids = list(reg.actions)
        taken = [a.shortcut for a in reg.actions.values() if a.shortcut]
        rng = random.Random(3)
        log = []
        for _ in range(40):
            aid = rng.choice(ids + ["missing"])
            choice = rng.random()
            sc = (None if choice < 0.1 else rng.choice(taken)
                  if choice < 0.5 else mod.Shortcut(
                      rng.choice("pqjkl"), ctrl=rng.random() < 0.5,
                      alt=rng.random() < 0.5))
            try:
                reg.rebind(aid, sc)
                log.append(("ok", aid, uc.plain(reg.get(aid).shortcut)))
            except (KeyError, ValueError) as e:
                log.append((type(e).__name__, aid, str(e)))
            if rng.random() < 0.2 and aid in reg.actions:
                try:
                    reg.reset_shortcut(aid)
                    log.append(("reset", aid,
                                uc.plain(reg.get(aid).shortcut)))
                except ValueError as e:     # its default is taken now
                    log.append(("reset refused", aid, str(e)))
        log.append(sorted((uc.plain(k), v)
                          for k, v in reg.shortcut_map.items()))
        return log
    ours, theirs = run(tact), run(jact)
    assert ours == theirs
    kinds = {e[0] for e in ours[:-1]}
    assert {"ok", "ValueError", "KeyError"} <= kinds
