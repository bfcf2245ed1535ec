"""The port's storage/ (host copies) against the JAX package's, on the CPU:

  * a file written through one package is read back through the other,
    in both directions, on three routes: `Storage` over `LocalStorage` in
    tmp_path, `CloudStorage` over a `MemoryCloudBackend`, and
    `CloudStorage` over `HttpCloudBackend` talking to the fake API of
    tests/torch_cloud_server.py on 127.0.0.1 (no network); the payload is
    a checkpoint (`checkpoint.save_bytes`) of 64 rollout states of the
    Cave-size level, which the reading package's `restore_bytes` turns
    back into the writer's states, equal on every leaf;
  * `async_ops`: a file saved by one package's `save_async` is loaded by
    the other's `load_async` and listed the same by both;
  * the errors are of the same kinds (`StorageError.kind`, or the
    exception's class): missing files locally, in memory and over HTTP,
    the 100 KiB file cap, the 1 MiB quota (preflight and the server's
    quota body), 429, a wrong and an absent token, a closed port;
  * the 1,024-state checkpoint is refused by both packages' cloud with
    FileTooLarge, the same size in the error;
  * the `Storage` facade routes `assets/userdata/*` to a cloud made by
    either package's `CloudStorage` and the rest to local files, the same
    way in both.

Tolerance: none; bytes and restored states are compared exactly.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import torch_cloud_server as fake
import torch_scenes as ts
from bonnie32_tpu import checkpoint as jckpt
from bonnie32_tpu import rollout as jrollout
from bonnie32_tpu import storage as jsto
from bonnie32_tpu.models import level as JL
from bonnie32_tpu_torch import checkpoint as tckpt
from bonnie32_tpu_torch import rollout as trollout
from bonnie32_tpu_torch import storage as tsto
from bonnie32_tpu_torch.models import level as TL

torch.set_num_threads(1)

PKGS = {"torch": tsto, "jax": jsto}
N_SMALL, N_BIG = 64, 1024
PATH = "assets/userdata/fleet/states.npz"


@pytest.fixture(scope="module")
def states():
    """64 rollout states of the Cave-size level from each package."""
    tl, jl = ts.cave_size_level(TL), ts.cave_size_level(JL)
    return {"torch": trollout.initial_states(tl, ts.spawn_point(tl), N_SMALL,
                                             device="cpu"),
            "jax": jrollout.initial_states(jl, ts.spawn_point(jl),
                                           N_SMALL)}


def _save(pkg, states):
    ck = tckpt if pkg == "torch" else jckpt
    return ck.save_bytes(states[pkg], metadata={"writer": pkg})


def _restore(pkg, data, states):
    ck = tckpt if pkg == "torch" else jckpt
    return ck.restore_bytes(data, states[pkg])


def _leaves_equal(a, b):
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, f)


def _cloud_module(pkg):
    return importlib.import_module(f"{PKGS[pkg].__name__}.cloud")


def _storage(pkg, route, root, url=None, objects=None):
    """`pkg`'s Storage facade on `route`: local files under `root`, or the
    cloud over `pkg`'s MemoryCloudBackend holding the object store
    `objects` (a dict both packages' backends share, as two clients of one
    bucket) or over the fake API at `url` (http)."""
    sto = PKGS[pkg]
    local = sto.LocalStorage(str(root))
    if route == "local":
        return sto.Storage(local=local)
    if route == "memory":
        backend = sto.MemoryCloudBackend()
        backend._objects = objects
        return sto.Storage(local=local, cloud=sto.CloudStorage(backend))
    http = _cloud_module(pkg).HttpCloudBackend(
        url, token_provider=lambda: fake.TOKEN)
    return sto.Storage(local=local, cloud=sto.CloudStorage(http))


@pytest.mark.parametrize("route", ["local", "memory", "http"])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_written_by_one_package_read_by_the_other(route, writer, reader,
                                                  states, tmp_path):
    data = _save(writer, states)
    assert 30_000 < len(data) < tsto.MAX_FILE_SIZE
    objects = {}
    with fake.serve() as (url, api):
        w = _storage(writer, route, tmp_path, url, objects)
        r = _storage(reader, route, tmp_path, url, objects)
        assert w.mode().value == r.mode().value
        assert w.is_sync(PATH) == r.is_sync(PATH) == (route == "local")
        w.write(PATH, data).wait()
        extra = bytes(np.random.default_rng(5).integers(
            0, 256, 3000, dtype=np.uint8))
        r.write("assets/userdata/fleet/extra.bin", extra).wait()
        got = r.read(PATH).wait()
        assert got == data
        assert w.read("assets/userdata/fleet/extra.bin").wait() == extra
        listed = {p: sorted(s.list("assets/userdata/fleet").wait())
                  for p, s in ((writer, w), (reader, r))}
        assert listed[writer] == listed[reader] == ["extra.bin",
                                                    "states.npz"]
        assert r.exists(PATH).wait() is True
        w.delete(PATH).wait()
        assert r.exists(PATH).wait() is False
        store = {"local": None, "memory": objects, "http": api.store}[route]
        if store is not None:
            assert sorted(store) == ["assets/userdata/fleet/extra.bin"]
    _leaves_equal(_restore(reader, got, states), states[writer])


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_async_ops_across_packages(writer, reader, states, tmp_path):
    data = _save(writer, states)
    path = os.path.join(str(tmp_path), "sub", "states.npz")
    assert PKGS[writer].save_async(path, data).wait() is True
    pending = PKGS[reader].load_async(path)
    got = pending.wait()
    assert pending.is_complete() and got == data
    lists = [sorted(PKGS[p].list_async(str(tmp_path / "sub")).wait())
             for p in (writer, reader)]
    assert lists[0] == lists[1] == ["states.npz"]
    _leaves_equal(_restore(reader, got, states), states[writer])


def _kind(fn):
    """The StorageError kind `fn` raises, or the exception class's name."""
    try:
        fn()
    except Exception as e:       # noqa: BLE001 — the kind is the result
        return getattr(e, "kind", type(e).__name__)
    return None


def _error_cases(pkg, tmp_path, url, api, closed_url):
    sto, cloud = PKGS[pkg], _cloud_module(pkg)
    local = sto.Storage(local=sto.LocalStorage(str(tmp_path)))
    http = cloud.HttpCloudBackend(url, token_provider=lambda: fake.TOKEN)
    big = b"x" * (sto.MAX_FILE_SIZE + 1)

    def quota_full():
        cs = sto.CloudStorage()
        for i in range(10):
            cs.write(f"assets/userdata/f{i}", b"x" * sto.MAX_FILE_SIZE).wait()
        return cs.write("assets/userdata/f10",
                        b"x" * sto.MAX_FILE_SIZE).wait()

    def flagged(flag, fn):
        setattr(api, flag, True)
        try:
            return fn()
        finally:
            setattr(api, flag, False)

    return {
        "local read of a missing file": lambda: local.read_sync("no/such"),
        "local list of a missing dir": lambda: local.list_sync("no/dir"),
        "async load of a missing file": lambda: sto.load_async(
            str(tmp_path / "missing.bin")).wait(),
        "memory read of a missing key": lambda: sto.CloudStorage().read(
            "assets/userdata/none").wait(),
        "cloud file over 100 KiB": lambda: sto.CloudStorage().write(
            "assets/userdata/big", big).take(),
        "cloud quota of 1 MiB": quota_full,
        "http 404": lambda: http.get("missing.ron"),
        "http 429": lambda: flagged("rate_limit_next",
                                    lambda: http.get("whatever")),
        "http quota body": lambda: flagged("quota_next",
                                           lambda: http.put("x", b"d")),
        "http wrong token": lambda: cloud.HttpCloudBackend(
            url, token_provider=lambda: "nope").get("a"),
        "http no token": lambda: cloud.HttpCloudBackend(url).get("a"),
        "http file over 100 KiB": lambda: sto.CloudStorage(http).write(
            "big.bin", big).wait(),
        "http closed port": lambda: cloud.HttpCloudBackend(
            closed_url, token_provider=lambda: fake.TOKEN,
            timeout_s=2.0).get("a"),
    }


ERROR_KINDS = {
    "local read of a missing file": "NotFound",
    "local list of a missing dir": "NotFound",
    "async load of a missing file": "FileNotFoundError",
    "memory read of a missing key": "NotFound",
    "cloud file over 100 KiB": "FileTooLarge",
    "cloud quota of 1 MiB": "QuotaExceeded",
    "http 404": "NotFound",
    "http 429": "RateLimited",
    "http quota body": "QuotaExceeded",
    "http wrong token": "AuthRequired",
    "http no token": "AuthRequired",
    "http file over 100 KiB": "FileTooLarge",
    "http closed port": "NetworkError",
}


@pytest.mark.parametrize("case", sorted(ERROR_KINDS))
def test_errors_are_the_same_kinds(case, tmp_path):
    with fake.serve() as (closed_url, _):
        pass                             # a port nothing listens on now
    kinds = {}
    with fake.serve() as (url, api):
        for pkg in PKGS:
            kinds[pkg] = _kind(_error_cases(pkg, tmp_path, url, api,
                                            closed_url)[case])
    assert kinds["torch"] == kinds["jax"] == ERROR_KINDS[case]


def test_oversize_checkpoint_is_refused_by_both_clouds():
    """The 1,024-state checkpoint is larger than a cloud file may be."""
    tl, jl = ts.cave_size_level(TL), ts.cave_size_level(JL)
    ours = tckpt.save_bytes(trollout.initial_states(
        tl, ts.spawn_point(tl), N_BIG, device="cpu"))
    theirs = jckpt.save_bytes(jrollout.initial_states(
        jl, ts.spawn_point(jl), N_BIG))
    assert len(ours) == len(theirs) > tsto.MAX_FILE_SIZE
    for sto in PKGS.values():
        for data in (ours, theirs):
            handle = sto.CloudStorage().write(PATH, data)
            assert handle.is_ready()
            with pytest.raises(Exception) as err:
                handle.take()
            assert err.value.kind == "FileTooLarge"
            assert err.value.info == {"size": len(ours),
                                      "max": tsto.MAX_FILE_SIZE}


def test_facade_routing_matches_jax(tmp_path):
    def run(pkg, factory_pkg):
        sto = PKGS[pkg]
        s = sto.Storage(local=sto.LocalStorage(str(tmp_path / pkg)))
        out = [s.mode().label, s.has_cloud(), s.is_sync(PATH),
               sto.Storage.is_userdata_path(PATH),
               sto.Storage.is_userdata_path("levels/a.ron")]
        s.write_sync("assets/userdata/x.bin", b"123")
        s.update_for_auth(True, cloud_factory=PKGS[factory_pkg].CloudStorage)
        s.write("assets/userdata/y.bin", b"cloud!").wait()
        s.write_string_sync("levels/z.ron", "local")
        out += [s.mode().label, s.is_sync(PATH), s.is_sync("levels/z.ron"),
                s.read("assets/userdata/y.bin").wait(),
                s.read_string_sync("levels/z.ron"),
                _kind(lambda: s.read("assets/userdata/x.bin").wait()),
                s.cloud.quota_used(), s.cloud.can_write(),
                s.cloud.quota_limit()]
        s.update_for_auth(False)
        out += [s.mode().label, s.read_sync("assets/userdata/x.bin"),
                sorted(os.listdir(tmp_path / pkg / "assets" / "userdata"))]
        return out
    runs = [run(p, f) for p in PKGS for f in PKGS]
    assert all(r == runs[0] for r in runs), runs
