"""The port's embedding server (dinox_torch.serve) on the CPU: health, embed
round trip, bucket padding and chunking, the spacing requirement, request
coalescing, shutdown — against a live ThreadingHTTPServer on a tiny hub dir
written by the JAX package — and embeddings equal to the JAX service's."""

import importlib.util
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest

from dinox_torch import serve
from dinox_tpu.models.config import ModelConfig
from dinox_tpu.models.vit import init_backbone
from dinox_tpu.zoo.hub import LoadedModel, export_hub_checkpoint

TINY = ModelConfig(name="tiny-serve", img_size=32, patch=16, dim=64, depth=2,
                   heads=2, out_dim=128, num_registers=4, scale_aware=True,
                   attn_impl="xla", dtype="float32")


def _hub(path):
    params = init_backbone(TINY, jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        params)
    export_hub_checkpoint(LoadedModel(TINY, params), path)
    return path


@pytest.fixture(scope="module")
def hub_dir(tmp_path_factory):
    return _hub(tmp_path_factory.mktemp("hub"))


@pytest.fixture(scope="module")
def server(hub_dir):
    service = serve.EmbedService(str(hub_dir), buckets=[2, 4], device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", service
    httpd.shutdown()
    httpd.server_close()
    service.close()


def _post(url, payload):
    req = urllib.request.Request(
        url + "/embed", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert body["model"] == {"dim": 64, "img_size": 32, "scale_aware": True}
    assert body["buckets"] == [2, 4]
    assert set(body["stats"]) == {"requests", "forwards", "images"}


def test_embed_round_trip_and_padding_invariance(server):
    url, service = server
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-100, 400, (3, 40, 40)).astype(np.float32)
    sps = [[0.7, 0.7, 1.5], [1.0, 1.0, 3.0], [0.5, 0.5, 1.0]]
    code, body = _post(url, {"images": imgs.tolist(), "spacings": sps})
    assert code == 200
    emb = np.asarray(body["embeddings"], np.float32)
    assert emb.shape == (3, 64) and body["dim"] == 64
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    # 3 images pad to bucket 4; the same image alone pads to bucket 2
    solo = service.embed([imgs[0]], [sps[0]])
    np.testing.assert_allclose(solo[0], emb[0], atol=1e-5)


def test_embed_chunking_beyond_largest_bucket(server):
    _, service = server
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(-100, 400, (32, 32)).astype(np.float32) for _ in range(7)]
    sps = [[1.0, 1.0, 2.0]] * 7
    before = service.stats["forwards"]
    emb = service.embed(imgs, sps)  # 7 > largest bucket 4 -> chunked 4 + 3
    assert emb.shape == (7, 64) and service.stats["forwards"] - before == 2
    one = service.embed([imgs[5]], [sps[5]])
    np.testing.assert_allclose(one[0], emb[5], atol=1e-5)


def test_embed_missing_spacing_rejected(server):
    url, _ = server
    code, body = _post(url, {"images": [[[0.0] * 32] * 32]})
    assert code == 400 and "spacings" in body["error"]


def _load_jax_serve():
    path = Path(__file__).resolve().parent.parent / "scripts" / "serve.py"
    spec = importlib.util.spec_from_file_location("serve_cli", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_embeddings_match_jax_service(server, hub_dir):
    _, service = server
    rng = np.random.default_rng(4)
    imgs = [rng.uniform(-1000, 1500, (48, 48)).astype(np.float32) for _ in range(3)]
    sps = [[0.7, 0.7, 1.5], [1.0, 1.0, 3.0], [2.0, 2.0, 5.0]]
    jax_service = _load_jax_serve().EmbedService(str(hub_dir), buckets=[2, 4], batch_window_ms=0.0)
    try:
        want = jax_service.embed(imgs, sps)
    finally:
        jax_service.close()
    got = service.embed(imgs, sps)
    # hub dirs load in bf16 compute in both packages: bf16 tolerance on
    # unit-norm embeddings
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert np.sum(got * want, axis=-1).min() >= 0.999


def test_concurrent_requests_coalesce_into_one_forward(hub_dir):
    service = serve.EmbedService(str(hub_dir), buckets=[4], batch_window_ms=500.0, device="cpu")
    try:
        rng = np.random.default_rng(2)
        imgs = rng.uniform(-100, 400, (4, 32, 32)).astype(np.float32)
        sp = [1.0, 1.0, 2.0]
        solo = service.embed([imgs[3]], [sp])
        base_forwards = service.stats["forwards"]
        results = [None] * 4
        barrier = threading.Barrier(4)

        def client(i):
            barrier.wait()
            results[i] = service.embed([imgs[i]], [sp])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert all(r is not None for r in results)
        assert service.stats["forwards"] - base_forwards < 4
        np.testing.assert_allclose(results[3][0], solo[0], atol=1e-5)
    finally:
        service.close()


def test_close_never_strands_a_request(hub_dir):
    service = serve.EmbedService(str(hub_dir), buckets=[2], batch_window_ms=0.0, device="cpu")
    img = np.random.default_rng(3).uniform(-100, 400, (32, 32)).astype(np.float32)
    sp = [1.0, 1.0, 2.0]
    service.embed([img], [sp])
    outcomes = [None] * 8
    barrier = threading.Barrier(9)

    def client(i):
        barrier.wait()
        try:
            outcomes[i] = service.embed([img], [sp]).shape
        except RuntimeError as e:
            outcomes[i] = str(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    barrier.wait()
    service.close()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), f"stranded: {outcomes}"
    for o in outcomes:
        assert o == (1, 64) or (isinstance(o, str) and "shut down" in o), o


def test_fused_attn_not_ported_yet(hub_dir):
    with pytest.raises(NotImplementedError):
        serve.EmbedService(str(hub_dir), buckets=[2], fused_attn=True, device="cpu")
