"""The port's serving engine against the reference's.

* ``ServeEngine.generate`` on reduced SmolLM (the reference's serve-test
  config), reduced RWKV-6, Hymba (hybrid, a window-8 ring cache that
  decode wraps and a 12-token prompt overflows), Mixtral and Kimi K2
  (MoE, dropless) with the reference's weights carried by
  ``params_from_numpy``: greedy tokens equal to the reference engine's on
  its own requests.
* ``migrate_kv``: the migrated cache (keys and values; RWKV-6's float32
  state beside its token-shift input, also in bfloat16; Hymba's keys,
  values, float32 SSM state and conv inputs, also in bfloat16) is
  bit-equal to the cache (and to the reference's migration), one dispatch
  per migration, the second one a fast-path hit.
* The engine's programs (run eagerly here, captured on the card): one
  engine serves batches of other shapes with fresh reference engines'
  tokens; at most ``PREFILL_PROGRAMS`` prefill programs are kept; what
  ``prefill`` returns shares no memory with them; one decode program step
  equals ``make_serve_step`` bit for bit.
* ``make_captured_decode_step`` at the reference test's sizes: the same
  recording as the reference (signature, lowered and scheduled graph
  digests under all five schedulers), attention within 2e-5 of the
  reference step's, the migrated KV chunk exact, one dispatch per call.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.comm import CommSession as JCommSession
from repro.comm.capture import lower_step as jlower_step
from repro.comm.passes import apply_schedule as japply_schedule
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import load_all as jload_all
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving.engine import (
    make_captured_decode_step as jmake_captured_decode_step)

from repro_torch.carry import params_from_numpy
from repro_torch.comm import CommSession, lower_step
from repro_torch.comm.config import SCHEDULE_NAMES
from repro_torch.comm.passes import apply_schedule
from repro_torch.configs import get_config
from repro_torch.core.topology import Topology
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as tfm_port
from repro_torch.serving import (Request, ServeEngine,
                                 make_captured_decode_step, make_serve_step)
from repro_torch.serving.engine import PREFILL_PROGRAMS

jload_all()

N = 8


def reduced_model(name):
    """(reference config, reference params, port config, port params)."""
    jcfg = JREGISTRY[name].reduced()
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, get_config(name).reduced(), params


@pytest.fixture(scope="module")
def smollm():
    return reduced_model("smollm_360m")


@pytest.fixture(scope="module")
def rwkv():
    return reduced_model("rwkv6_1_6b")


@pytest.fixture(scope="module")
def hymba():
    return reduced_model("hymba_1_5b")


@pytest.fixture(scope="module")
def mixtral():
    return reduced_model("mixtral_8x22b")


@pytest.fixture(scope="module")
def kimi():
    return reduced_model("kimi_k2_1t_a32b")


REQUESTS = {
    "two": (48, [([1, 2, 3], 5), ([7, 8, 9, 10], 8)]),
    "one": (32, [([5, 6, 7], 6)]),
    # a prompt longer than the reduced models' window of 8
    "long": (48, [(list(range(3, 15)), 6), ([9, 8, 7], 4)]),
}


def check_greedy_equals_reference(model, case):
    jcfg, jparams, cfg, params = model
    max_len, reqs = REQUESTS[case]
    want = JServeEngine(jcfg, jparams, max_len=max_len, kv_chunks=4
                        ).generate([JRequest(list(p), n) for p, n in reqs])
    engine = ServeEngine(cfg, params, max_len=max_len, kv_chunks=4)
    got = engine.generate([Request(list(p), n) for p, n in reqs])
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == [n for _, n in reqs]
    assert all(r.done for r in got)
    again = engine.generate([Request(list(p), n) for p, n in reqs])
    assert [r.out for r in again] == [r.out for r in got]


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_generate_greedy_equals_reference(smollm, case):
    check_greedy_equals_reference(smollm, case)


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_rwkv_generate_greedy_equals_reference(rwkv, case):
    check_greedy_equals_reference(rwkv, case)


@pytest.mark.parametrize("case", sorted(REQUESTS))
@pytest.mark.parametrize("name", ["hymba", "mixtral", "kimi"])
def test_hybrid_and_moe_generate_greedy_equals_reference(request, name,
                                                         case):
    check_greedy_equals_reference(request.getfixturevalue(name), case)


# -- the engine's programs -------------------------------------------------

#: Batches one engine serves in turn: (max new tokens, prompts).
BATCHES = [(5, [[1, 2, 3], [7, 8, 9, 10]]),
           (4, [[4, 5, 6, 7, 8, 9], [3], [11, 12]]),
           (6, [[2, 3, 4], [9, 9]])]


@pytest.mark.parametrize("name", ["smollm", "rwkv", "hymba", "mixtral"])
def test_one_engine_serves_batches_of_other_shapes(request, name):
    """Batches of other sizes and prompt lengths in turn through one
    engine (per-shape programs, decode caches shared by batch size) give
    fresh reference engines' greedy tokens."""
    jcfg, jparams, cfg, params = request.getfixturevalue(name)
    engine = ServeEngine(cfg, params, max_len=32, kv_chunks=4)
    for new, prompts in BATCHES:
        want = JServeEngine(jcfg, jparams, max_len=32, kv_chunks=4
                            ).generate([JRequest(list(p), new)
                                        for p in prompts])
        got = engine.generate([Request(list(p), new) for p in prompts])
        assert [r.out for r in got] == [r.out for r in want]
    assert sorted(engine._decodes) == [2, 3]
    assert sorted(engine._prefills) == [(2, 3), (2, 4), (3, 6)]


def eager_greedy(cfg, params, spec, prompts, new):
    """Greedy tokens of an eager loop: ``prefill_forward``, then
    ``make_serve_step`` and ``argmax``, with the engine's left padding."""
    plen = max(len(p) for p in prompts)
    toks = torch.tensor([[0] * (plen - len(p)) + p for p in prompts])
    logits, cache = tfm_port.prefill_forward(params, cfg, {"tokens": toks},
                                             spec)
    step = make_serve_step(cfg, spec)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for i in range(new - 1):
        logits, cache = step(params, cache, tok[:, None], plen + i)
        tok = logits.argmax(-1)
        out.append(tok)
    return torch.stack(out, 1).tolist()


def test_prefill_programs_are_bounded(smollm):
    """Six prompt shapes through one engine keep the PREFILL_PROGRAMS
    most recently used programs, and every batch's tokens equal the eager
    loop's; a shape served again after its program was dropped too."""
    _, _, cfg, params = smollm
    engine = ServeEngine(cfg, params, max_len=32, kv_chunks=4)
    shapes = [(1, 3), (2, 3), (1, 5), (2, 6), (1, 7), (2, 4), (1, 3)]
    for i, (b, s) in enumerate(shapes):
        prompts = [[(7 * i + 3 * j + t) % cfg.vocab_size for t in range(s)]
                   for j in range(b)]
        got = engine.generate([Request(list(p), 4) for p in prompts])
        assert [r.out for r in got] == eager_greedy(cfg, params, engine.spec,
                                                    prompts, 4)
        assert len(engine._prefills) == min(i + 1, PREFILL_PROGRAMS)
    assert list(engine._prefills) == shapes[-PREFILL_PROGRAMS:]
    assert sorted(engine._decodes) == [1, 2]


def test_prefill_returns_new_tensors(smollm):
    """The logits and cache that ``prefill`` returns share no memory with
    the engine's programs: a later ``generate`` leaves them as they were,
    and changing them leaves the next ``generate``'s tokens unchanged."""
    _, _, cfg, params = smollm
    engine = ServeEngine(cfg, params, max_len=32, kv_chunks=4)
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8]]

    def reqs():
        return [Request(list(p), 5) for p in prompts]

    first = [r.out for r in engine.generate(reqs())]
    logits, cache = engine.prefill(prompts)
    prog = engine.prefill_program(2, 4)
    static = {t.untyped_storage().data_ptr()
              for t in [*prog.inputs(), *prog.outputs(),
                        *engine.decode_program(2).inputs()]}
    assert not static & {t.untyped_storage().data_ptr()
                         for t in [logits, *cache.values()]}
    kept = logits.clone(), {k: t.clone() for k, t in cache.items()}
    assert [r.out for r in engine.generate(reqs())] == first
    assert torch.equal(logits, kept[0])
    assert all(torch.equal(cache[k], kept[1][k]) for k in cache)
    logits.fill_(5.0)
    for t in cache.values():
        t.fill_(-3.0)
    assert [r.out for r in engine.generate(reqs())] == first


@pytest.mark.parametrize("name", ["smollm", "rwkv", "hymba", "mixtral",
                                  "kimi"])
def test_decode_program_step_is_serve_step(request, name):
    """One call of the decode program gives ``make_serve_step``'s logits
    and cache on the same cache, token and position, bit for bit."""
    _, _, cfg, params = request.getfixturevalue(name)
    engine = ServeEngine(cfg, params, max_len=16, kv_chunks=4)
    prefill = engine.prefill_program(2, 5)
    prefill.tokens.copy_(torch.tensor([[3, 4, 5, 6, 7], [1, 1, 2, 3, 5]]))
    logits = prefill()
    decode = engine.decode_program(2)
    eager = {k: t.clone() for k, t in decode.cache.items()}
    tok = logits[:, -1].argmax(-1)[:, None]
    want, _ = make_serve_step(cfg, engine.spec)(params, eager, tok, 5)
    decode.tokens.copy_(tok)
    decode.cur_len.fill_(5)
    assert torch.equal(decode(), want)
    assert all(torch.equal(decode.cache[k], eager[k]) for k in eager)
    assert (decode.calls, decode.replays) == (1, 0)


def test_generate_checks_the_cache_length(smollm):
    _, _, cfg, params = smollm
    engine = ServeEngine(cfg, params, max_len=8, kv_chunks=4)
    assert len(engine.generate([Request([1, 2, 3], 6)])[0].out) == 6
    with pytest.raises(ValueError, match="max_len 8"):
        engine.generate([Request([1, 2, 3], 7)])


def test_serve_step_is_decode_step(smollm):
    _, _, cfg, params = smollm
    engine = ServeEngine(cfg, params, max_len=16, kv_chunks=4)
    logits, cache = engine.prefill([[3, 4, 5, 6]])
    step = make_serve_step(cfg, engine.spec)
    nxt = torch.argmax(logits[:, -1], -1)[:, None]
    lg, same = step(params, cache, nxt, 4)
    assert same is cache and lg.shape == (1, cfg.vocab_size)


def test_temperature_sampling_is_seeded(smollm):
    _, _, cfg, params = smollm
    engine = ServeEngine(cfg, params, max_len=32, kv_chunks=4,
                         temperature=0.8)

    def run(seed):
        return [r.out for r in engine.generate(
            [Request([1, 2, 3], 6), Request([9, 8], 4)], seed=seed)]

    first = run(0)
    assert run(0) == first
    assert all(0 <= t < cfg.vocab_size for out in first for t in out)
    assert [len(o) for o in first] == [6, 4]


def check_migration(engine, cache):
    """Two migrations 0→1: each bit-equal, one dispatch each, the second a
    fast-path hit. Returns the first migration's cache."""
    sess = engine.comm
    moved = engine.migrate_kv(cache, 0, 1)
    assert sorted(moved) == sorted(cache)
    for key in cache:
        assert moved[key].dtype == cache[key].dtype
        assert torch.equal(moved[key], cache[key])
    s1 = sess.stats()
    assert s1["dispatches"] == 1 and s1["cache"]["size"] == 1
    again = engine.migrate_kv(cache, 0, 1)
    s2 = sess.stats()
    assert s2["dispatches"] == 2
    assert s2["fastpath"]["hits"] == s1["fastpath"]["hits"] + 1
    assert all(torch.equal(again[k], cache[k]) for k in cache)
    return moved


def check_migrate_matches_reference(model, dev_mesh):
    jcfg, jparams, cfg, params = model
    engine = ServeEngine(cfg, params, max_len=48, kv_chunks=4,
                         comm=CommSession(device="cpu"))
    toks = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]]
    _, cache = engine.prefill(toks)
    moved = check_migration(engine, cache)
    jengine = JServeEngine(jcfg, jparams, max_len=48, kv_chunks=4,
                           comm=JCommSession(mesh=dev_mesh))
    _, jcache = jengine.prefill(np.asarray(toks, np.int32))
    jmoved = jengine.migrate_kv(jcache, 0, 1)
    for key in cache:
        np.testing.assert_allclose(moved[key].numpy(),
                                   np.asarray(jmoved[key]), atol=1e-4,
                                   rtol=0)
    with pytest.raises(ValueError, match="CommSession"):
        ServeEngine(cfg, params).migrate_kv(cache, 0, 1)


def test_migrate_kv_exact_one_dispatch_fast_path(smollm, dev_mesh):
    check_migrate_matches_reference(smollm, dev_mesh)


def test_rwkv_migrate_kv_exact_one_dispatch_fast_path(rwkv, dev_mesh):
    check_migrate_matches_reference(rwkv, dev_mesh)


def test_hybrid_migrate_kv_exact_one_dispatch_fast_path(hymba, dev_mesh):
    check_migrate_matches_reference(hymba, dev_mesh)


def test_hybrid_bf16_cache_migrates_bitwise():
    """A bfloat16 Hymba cache mixes dtypes: bfloat16 keys, values and conv
    inputs beside the float32 SSM state ride one transfer group, to a
    device other than the next one."""
    cfg = dataclasses.replace(get_config("hymba_1_5b").reduced(),
                              dtype="bfloat16")
    params = tfm_port.init_params(
        cfg, generator=torch.Generator().manual_seed(0))
    engine = ServeEngine(cfg, params, max_len=32,
                         comm=CommSession(device="cpu"))
    _, cache = engine.prefill([list(range(1, 13)), list(range(20, 32))])
    assert sorted(cache) == ["conv", "k", "ssm", "v"]
    assert cache["ssm"].dtype == torch.float32
    assert {cache[k].dtype for k in ("k", "v", "conv")} == {torch.bfloat16}
    moved = engine.migrate_kv(cache, 0, 2)
    assert all(moved[k].dtype == cache[k].dtype
               and torch.equal(moved[k], cache[k]) for k in cache)
    assert engine.comm.stats()["dispatches"] == 1


def test_rwkv_bf16_state_cache_migrates_bitwise():
    """A bfloat16 RWKV-6 cache mixes dtypes: the float32 state beside the
    bfloat16 token-shift input ride one transfer group."""
    cfg = dataclasses.replace(get_config("rwkv6_1_6b").reduced(),
                              dtype="bfloat16")
    params = tfm_port.init_params(
        cfg, generator=torch.Generator().manual_seed(0))
    engine = ServeEngine(cfg, params, max_len=32,
                         comm=CommSession(device="cpu"))
    _, cache = engine.prefill([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]])
    assert cache["rwkv_state"].dtype == torch.float32
    assert cache["rwkv_shift"].dtype == torch.bfloat16
    check_migration(engine, cache)


def test_send_pytree_structure_and_no_ops():
    sess = CommSession(device="cpu")
    tree = {"b": [torch.arange(6.0), (torch.ones(2, 3),)],
            "a": torch.zeros(0), "c": {"d": torch.full((4,), 2.0)}}
    out = sess.send_pytree(tree, 0, 2)
    assert sorted(out) == ["a", "b", "c"]
    assert isinstance(out["b"], list) and isinstance(out["b"][1], tuple)
    assert torch.equal(out["b"][0], tree["b"][0])
    assert torch.equal(out["b"][1][0], tree["b"][1][0])
    assert torch.equal(out["c"]["d"], tree["c"]["d"])
    assert out["a"].numel() == 0
    assert sess.stats()["dispatches"] == 1
    same = sess.send_pytree(tree, 1, 1)
    assert same["c"]["d"] is tree["c"]["d"]
    assert sess.stats()["dispatches"] == 1


# -- the captured decode step ---------------------------------------------

DECODE = dict(batch=1, heads=2, kv_len=16, head_dim=8, kv_chunk=4096,
              src=0, dst=2)


def sessions(dev_mesh):
    return (JCommSession(mesh=dev_mesh),
            CommSession(device="cpu",
                        topology=Topology.full_mesh(N, with_host=True)))


def test_captured_decode_step_matches_reference(dev_mesh):
    jsess, sess = sessions(dev_mesh)
    jstep = jmake_captured_decode_step(jsess, schedule="overlap", **DECODE)
    step = make_captured_decode_step(sess, schedule="overlap", **DECODE)
    rng = np.random.default_rng(3)
    shp = (N, 1, 2, 16, 8)
    q, k, v = (rng.random(shp).astype(np.float32) for _ in range(3))
    kv = rng.random((N, 4096)).astype(np.float32)
    jattn, jnew = jstep(q, k, v, kv)
    attn, new_kv = step(*(torch.from_numpy(a) for a in (q, k, v, kv)))
    assert sess.stats()["dispatches"] == 1
    np.testing.assert_allclose(attn.numpy(), np.asarray(jattn), atol=2e-5,
                               rtol=2e-5)
    expect = kv.copy()
    expect[2] = kv[0]
    np.testing.assert_array_equal(new_kv.numpy(), expect)
    np.testing.assert_array_equal(new_kv.numpy(), np.asarray(jnew))
    step(*(torch.from_numpy(a) for a in (q, k, v, kv)))
    assert sess.stats()["dispatches"] == 2
    assert sess.stats()["fastpath"]["hits"] >= 1


def test_captured_decode_step_digests_equal_reference(dev_mesh):
    jsess, sess = sessions(dev_mesh)
    jcap = jmake_captured_decode_step(jsess, **DECODE).capture
    cap = make_captured_decode_step(sess, **DECODE).capture
    assert cap.signature() == jcap.signature()
    jgraph, _ = jlower_step(jcap, jsess.engine.plan_group_for,
                            jsess.topology.name)
    graph, _ = lower_step(cap, sess.engine.plan_group_for,
                          sess.topology.name)
    assert graph.digest() == jgraph.digest()
    assert graph.num_compute_nodes == 3 and graph.num_copy_nodes > 0
    for sched in SCHEDULE_NAMES:
        jsched, jchosen = japply_schedule(jgraph, sched, jsess.topology)
        ours, chosen = apply_schedule(graph, sched, sess.topology)
        assert (ours.digest(), chosen) == (jsched.digest(), jchosen), sched


def test_captured_decode_step_rejects_bad_endpoints():
    sess = CommSession(device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        make_captured_decode_step(sess, **{**DECODE, "dst": 0})
    with pytest.raises(ValueError, match="distinct"):
        make_captured_decode_step(sess, **{**DECODE, "dst": 9})


def test_cli_serves_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", "gemma3_27b",
                    "--requests", "2", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "req1:" in out and "6 tokens in" in out


def test_cli_serves_rwkv_on_the_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", "rwkv6_1_6b",
                    "--requests", "2", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "req1:" in out and "6 tokens in" in out


@pytest.mark.parametrize("arch", ["hymba_1_5b", "mixtral_8x22b"])
def test_cli_serves_hybrid_and_moe_on_the_cpu(capsys, arch):
    serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                    "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "req1:" in out and "6 tokens in" in out
