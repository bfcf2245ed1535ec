"""The port's checkpoint module (bonnie32_tpu_torch/checkpoint.py) on the
CPU: the round trip; the file format against the JAX package's — a
batched GameState and Events written by either package restore in the
other, equal on every leaf, and the keys of a tree of NamedTuples,
tuples, lists and dicts are `jax.tree_util`'s; the two ValueErrors with
the JAX messages; bytes; dtypes cast to the template's; and a resumed
rollout (2 frames, save, restore, 2 more) equal bit for bit to 4 frames
run straight through.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenes as ts
from bonnie32_tpu import checkpoint as jckpt
from bonnie32_tpu.game import events as jev
from bonnie32_tpu.game import state as jst
from bonnie32_tpu_torch import checkpoint as ckpt
from bonnie32_tpu_torch import rollout
from bonnie32_tpu_torch.config import RasterSettings
from bonnie32_tpu_torch.game import events as tev
from bonnie32_tpu_torch.game import state as tst
from bonnie32_tpu_torch.game import step as stp
from bonnie32_tpu_torch.models import level as TL
from bonnie32_tpu_torch.tree import leaves_with_paths

torch.set_num_threads(1)
N, CAP = 4, 8


def jax_states(n=N, cap=CAP):
    """tests/test_checkpoint.py's batch: one enemy an instance."""
    def one(i):
        s = jst.new_state(cap)
        s, _ = jst.spawn(s, jst.KIND_ENEMY, (float(i), 0.0, 0.0), hp=5 + i)
        return s
    return jax.tree.map(lambda *xs: jnp.stack(xs), *[one(i)
                                                     for i in range(n)])


def port_states(n=N, cap=CAP):
    """The same batch built by the port."""
    s = tst.new_state(n, cap, device="cpu")
    pos = torch.tensor([[float(i), 0.0, 0.0] for i in range(n)])
    s, _ = tst.spawn(s, tst.KIND_ENEMY, pos,
                     hp=torch.arange(5, 5 + n, dtype=torch.int32))
    return s


def jax_events(n=N):
    evs = []
    for i in range(n):
        e = jev.new_events(CAP)
        e = e._replace(damage=jev.push(e.damage, a=3 + i, c=9,
                                       pos=(1.0, 2.0, float(i))))
        evs.append(e)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *evs)


def _assert_tree_equal(port_tree, jax_tree):
    ours = leaves_with_paths(port_tree)
    theirs = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(ours) == len(theirs)
    for (p, a), (jp, b) in zip(ours, theirs):
        b = np.asarray(b)
        assert "/".join(p) == jckpt_key(jp)
        assert a.numpy().dtype == b.dtype, "/".join(p)
        np.testing.assert_array_equal(a.numpy(), b, err_msg="/".join(p))


def jckpt_key(path):
    """The JAX module's key of a leaf path."""
    return "/".join(str(getattr(p, "name", getattr(p, "idx", p)))
                    for p in path)


def test_port_states_are_the_jax_batch():
    _assert_tree_equal(port_states(), jax_states())


def test_save_restore_roundtrip(tmp_path):
    states = port_states()
    p = str(tmp_path / "roll.ckpt.npz")
    ckpt.save(p, states, metadata={"frame": 120, "level": "Cave"})
    meta = ckpt.load_metadata(p)
    assert meta["format_version"] == 1
    assert meta["n_leaves"] == len(tst.GameState._fields)
    assert meta["user"] == {"frame": 120, "level": "Cave"}
    restored = ckpt.restore(p, tst.new_state(N, CAP, device="cpu"))
    assert type(restored) is tst.GameState
    for f in tst.GameState._fields:
        a, b = getattr(states, f), getattr(restored, f)
        assert a.dtype == b.dtype and a.device == b.device
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["states", "events"])
def test_jax_written_restores_in_the_port(tmp_path, kind):
    p = str(tmp_path / "jax.npz")
    if kind == "states":
        tree = jax_states()
        template = tst.new_state(N, CAP, device="cpu")
    else:
        tree = jax_events()
        template = tev.new_events(N, CAP, device="cpu")
    jckpt.save(p, tree, metadata={"by": "jax"})
    assert ckpt.load_metadata(p)["user"] == {"by": "jax"}
    _assert_tree_equal(ckpt.restore(p, template), tree)


@pytest.mark.parametrize("kind", ["states", "events"])
def test_port_written_restores_in_jax(tmp_path, kind):
    p = str(tmp_path / "port.npz")
    if kind == "states":
        tree = port_states()
        template = jax.tree.map(lambda *xs: jnp.stack(xs),
                                *[jst.new_state(CAP) for _ in range(N)])
    else:
        tree = tev.new_events(N, CAP, device="cpu")
        tree = tree._replace(damage=tev.push(
            tree.damage, a=torch.arange(3, 3 + N, dtype=torch.int32), c=9,
            pos=(1.0, 2.0, 0.5)))
        template = jax.tree.map(lambda *xs: jnp.stack(xs),
                                *[jev.new_events(CAP) for _ in range(N)])
    ckpt.save(p, tree, metadata={"by": "port"})
    assert jckpt.load_metadata(p) == ckpt.load_metadata(p)
    _assert_tree_equal(tree, jckpt.restore(p, template))


def test_keys_match_jax_on_nested_containers(tmp_path):
    """NamedTuples, tuples, lists, dicts and None nested: the file's keys
    are the JAX module's, and both packages restore it."""
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(4)]
    q = tev.new_queue(2, 3, device="cpu")
    port_tree = {"b": (torch.from_numpy(arrs[0]), [torch.from_numpy(arrs[1]),
                                                   None]),
                 "a": {"z": torch.from_numpy(arrs[2]), "q": q},
                 "c": [torch.from_numpy(arrs[3])]}
    jq = jax.tree.map(jnp.asarray, jax.tree.map(lambda t: t.numpy(), q))
    jq = jev.EventQueue(*jq)
    jax_tree = {"b": (jnp.asarray(arrs[0]), [jnp.asarray(arrs[1]), None]),
                "a": {"z": jnp.asarray(arrs[2]), "q": jq},
                "c": [jnp.asarray(arrs[3])]}
    p, jp = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ckpt.save(p, port_tree)
    jckpt.save(jp, jax_tree)
    with np.load(p) as z, np.load(jp) as jz:
        assert sorted(z.files) == sorted(jz.files)
        assert "a/['q']/pos" not in z.files
        assert "['a']/['q']/pos" in z.files and "['b']/0" in z.files
        for k in z.files:
            if k != "__meta__":
                np.testing.assert_array_equal(z[k], jz[k])
        assert json.loads(bytes(z["__meta__"])) == \
            json.loads(bytes(jz["__meta__"]))
    back = ckpt.restore(jp, port_tree)
    assert back["b"][1][1] is None and type(back["a"]["q"]) is tev.EventQueue
    _assert_tree_equal(back, jax_tree)


def test_restore_validates(tmp_path):
    p = str(tmp_path / "x.npz")
    ckpt.save(p, port_states())
    with pytest.raises(ValueError, match=r"leaf alive: shape \(4, 8\) != "
                       r"template \(4, 16\)"):
        ckpt.restore(p, tst.new_state(N, 16, device="cpu"))
    with pytest.raises(ValueError, match="checkpoint missing leaves: "
                       r"\['damage/count'"):
        ckpt.restore(p, tev.new_events(N, device="cpu"))
    blob = ckpt.save_bytes(port_states())
    with pytest.raises(ValueError, match="checkpoint missing leaf: "
                       "damage/count"):
        ckpt.restore_bytes(blob, tev.new_events(N, device="cpu"))
    # the JAX package's messages, word for word
    with pytest.raises(ValueError) as jerr:
        jckpt.restore(p, jax.tree.map(lambda *xs: jnp.stack(xs),
                                      *[jst.new_state(16)
                                        for _ in range(N)]))
    with pytest.raises(ValueError) as err:
        ckpt.restore(p, tst.new_state(N, 16, device="cpu"))
    assert str(err.value) == str(jerr.value)


def test_bytes_roundtrip():
    evs = tev.new_events(N, device="cpu")
    evs = evs._replace(damage=tev.push(evs.damage, a=3, c=9))
    blob = ckpt.save_bytes(evs, metadata={"k": 1})
    back = ckpt.restore_bytes(blob, tev.new_events(N, device="cpu"))
    assert back.damage.count.tolist() == [1] * N
    assert back.damage.a[:, 0].tolist() == [3] * N
    jback = jckpt.restore_bytes(blob, jax.tree.map(
        lambda *xs: jnp.stack(xs), *[jev.new_events(32) for _ in range(N)]))
    _assert_tree_equal(back, jback)


def test_restore_casts_to_the_template(tmp_path):
    """64-bit leaves (the JAX tests run with x64 on) restore as the
    template's dtypes, on the template's device."""
    p = str(tmp_path / "wide.npz")
    jckpt.save(p, {"f": jnp.arange(6, dtype=jnp.float64).reshape(2, 3),
                   "i": jnp.arange(4, dtype=jnp.int64),
                   "n": np.float64(2.5), "k": 7})
    template = {"f": torch.zeros((2, 3)),
                "i": torch.zeros(4, dtype=torch.int32),
                "n": np.zeros((), np.float32), "k": 0}
    back = ckpt.restore(p, template)
    assert back["f"].dtype == torch.float32
    assert back["i"].dtype == torch.int32
    assert back["f"].tolist() == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
    assert back["i"].tolist() == [0, 1, 2, 3]
    assert back["n"].dtype == np.float32 and float(back["n"]) == 2.5
    assert back["k"] == 7 and type(back["k"]) is int


def test_resume_equals_the_straight_run(tmp_path):
    """2 frames, save, restore into a fresh template, 2 more: frames and
    states equal 4 frames run straight through, bit for bit (the kernel
    route's plain twins, 24x32)."""
    level = ts.cave_size_level(TL)
    env = rollout.build_env(level, ts.textures(), ts.resolver, device="cpu")
    settings = RasterSettings.game()
    rng = np.random.default_rng(4)
    acts = [stp.Actions(**{k: torch.from_numpy(v) for k, v in
                           ts.actions_np(rng, N).items()}) for _ in range(4)]

    def run(states, frames):
        fb = None
        for a in frames:
            states, fb = rollout.step_and_render(states, env, a, settings,
                                                 height=24, width=32)
        return states, fb

    start = rollout.initial_states(level, ts.spawn_point(level), N,
                                   device="cpu")
    straight, fb = run(start, acts)
    half, _ = run(start, acts[:2])
    p = str(tmp_path / "half.npz")
    ckpt.save(p, half, metadata={"frame": 2})
    fresh = rollout.initial_states(level, ts.spawn_point(level), N,
                                   device="cpu")
    resumed, rfb = run(ckpt.restore(p, fresh), acts[2:])
    assert ckpt.load_metadata(p)["user"]["frame"] == 2
    assert ((fb.color >> 24) & 255).eq(255).float().mean() > 0.25
    assert torch.equal(rfb.color, fb.color)
    assert torch.equal(rfb.depth.view(torch.int32), fb.depth.view(torch.int32))
    for f in tst.GameState._fields:
        a, b = getattr(resumed, f), getattr(straight, f)
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
