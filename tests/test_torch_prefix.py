"""The port's prefix cache (gofr_tpu_torch.kvcache: BlockPool sharing,
RadixTree, CacheManager seeding and publishing, copy_blocks,
gather_blocks_host; the engine's exact and block-partial hits) against
gofr_tpu's on the CPU: the same op sequences give the same matches,
refcounts, free lists and counters; the device helpers are byte-equal;
the engine serves JAX's greedy tokens with JAX's prefix counters, leaks
no pin and never writes a shared block."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.kvcache import CacheManager as JCacheManager
from gofr_tpu.kvcache import paged as JP
from gofr_tpu.llm import GenRequest as JRequest
from gofr_tpu.llm import LLMEngine as JEngine
from gofr_tpu.models import transformer as JT
from gofr_tpu_torch.kvcache import CacheManager, paged as TP
from gofr_tpu_torch.llm import GenRequest, LLMEngine
from gofr_tpu_torch.models import transformer as TT

ENGINE_KW = dict(slots=4, max_seq_len=96, prefill_buckets=(8, 32))  # tests/test_paged_kv.py's prefix engine


@pytest.fixture(scope="module")
def weights():
    jcfg = JT.TransformerConfig.tiny()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    # untied random head: the tied tiny model repeats its input token
    jp = dict(jp, unembed=jax.random.normal(
        jax.random.PRNGKey(9), (jcfg.vocab_size, jcfg.d_model), jnp.float32
    ))
    tcfg = TT.TransformerConfig.tiny()
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _radix_refs(radix, n_blocks: int) -> np.ndarray:
    """References the radix tree holds on each pool block."""
    refs = np.zeros(n_blocks, np.int32)
    stack = [radix.root]
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        for b in n.blocks:
            refs[b] += 1
        for e in n.ends.values():
            if e.tail_block is not None:
                refs[e.tail_block] += 1
    return refs


def _settled(eng, timeout=10.0) -> dict:
    """Wait until the engine is idle: no request in a slot, no promise
    outstanding, nothing in flight. Returns its stats."""
    t0 = time.perf_counter()
    while True:
        st = eng.stats()
        with eng._lock:  # no session turn awaiting its publish, no session over its budget
            idle = not eng._inflight and eng._processing is None and all(r is None for r in eng._slot_req)
            idle = idle and not eng._session_pub and not eng.kv.spill_candidates()
        if idle and st["kvcache"]["reserved"] == 0 and st["kvcache"]["blocks_in_use"] == eng.kv.held_blocks():
            return st
        assert time.perf_counter() - t0 < timeout, st["kvcache"]
        time.sleep(0.01)


def _assert_no_leaked_pins(eng) -> None:
    """Once idle, every block's refcount is exactly the radix's references
    to it: no slot, plan or pin holds any other."""
    _settled(eng)
    with eng.kv._lock:
        want = _radix_refs(eng.kv.radix, eng.kv.pool.n_blocks)
        np.testing.assert_array_equal(eng.kv.pool.refs, want)


# -- host bookkeeping: the same seeded op sequence on both packages --------

def _tree_dump(radix) -> list:
    out, stack = [], [((), radix.root)]
    while stack:
        path, n = stack.pop()
        path = path + n.tokens
        out.append((path, list(n.blocks), n.refs,
                    sorted((k, e.tail_block, e.tail_len, e.nbytes) for k, e in n.ends.items())))
        stack.extend((path, c) for c in n.children.values())
    return sorted(out)


@pytest.mark.parametrize("seed", range(6))
def test_radix_and_pool_ops_match_jax(seed):
    """Publishes (with dedup of existing paths and of losing tail copies),
    lookups, pins, mid-edge splits and both evictions, on a small alphabet
    so sequences collide, at block 4: the JAX RadixTree/BlockPool and the
    port's give the same matches, refcounts, free lists, trees and stats
    after every op."""
    B, NB = 4, 48
    rng = np.random.default_rng(seed)
    sides = []
    capacity = int(rng.integers(0, 3)) * 1500
    for mod in (JP, TP):
        pool = mod.BlockPool(NB, B, 100)
        sides.append((pool, mod.RadixTree(pool, B, capacity_bytes=capacity)))
    roots = [rng.integers(1, 4, 12).tolist() for _ in range(3)]
    pins: list[tuple] = []

    published: list[list[int]] = []

    def seq(op):
        if op != "publish" and published and rng.integers(0, 2):
            return published[int(rng.integers(0, len(published)))]  # an exact probe
        s = list(roots[int(rng.integers(0, 3))]) + rng.integers(1, 3, int(rng.integers(0, 14))).tolist()
        s = s[: int(rng.integers(1, len(s) + 1))]
        if op == "publish":
            published.append(s)
        return s

    for step in range(120):
        op = rng.choice(["publish", "publish", "lookup", "lookup", "pin", "unpin", "evict_for", "evict_to"])
        args = (seq(op), bool(rng.integers(0, 2)), int(rng.integers(0, 2)) * 64, int(rng.integers(1, 6)),
                int(rng.integers(0, 4000)))
        results = []
        for i, (pool, radix) in enumerate(sides):
            toks, want_tail, nbytes, n_ev, budget = args
            if op == "publish":
                n_full = len(toks) // B
                tail = want_tail and len(toks) % B > 0
                if pool.available() < n_full + tail:
                    radix.evict_for(n_full + tail - pool.available())
                if pool.available() < n_full + tail:
                    results.append(None)
                    continue
                blocks = pool.alloc(n_full)
                tail_block = pool.alloc(1)[0] if tail else None
                node, key = radix.insert(toks, blocks, tail_block=tail_block, tail_len=len(toks) % B,
                                         logits="L" if nbytes else None, logits_nbytes=nbytes)
                pool.decref(blocks)  # the publishing slot retires
                results.append((node.depth_tokens(), key))
            elif op == "lookup":
                m = radix.lookup(toks)
                results.append((m.blocks, m.shared, None if m.end is None else (m.end.tail_block, m.end.tail_len),
                                m.node.depth_tokens()))
            elif op == "pin":
                m = radix.lookup(toks)
                if m.node is not radix.root:
                    radix.pin(m.node)
                    if i == 0:
                        pins.append([m.node])
                    else:
                        pins[-1].append(m.node)
                results.append(m.node is radix.root)
            elif op == "unpin":
                if pins and len(pins[0]) == 2:
                    radix.unpin(pins[0][i])
                    if i == 1:
                        pins.pop(0)
                results.append(None)
            elif op == "evict_for":
                results.append(radix.evict_for(n_ev))
            else:
                results.append(radix.evict_to(budget))
        assert results[0] == results[1], (step, op, results)
        (jpool, jradix), (tpool, tradix) = sides
        np.testing.assert_array_equal(jpool.refs, tpool.refs)
        assert jpool._free == tpool._free and jpool.reserved == tpool.reserved
        assert jradix.stats() == tradix.stats(), (step, op)
        assert _tree_dump(jradix) == _tree_dump(tradix), (step, op)
    assert tradix.stats()["stores"] and tradix.stats()["hits"] and tradix.stats()["partial_hits"]


def test_pool_sharing_and_cow_seam_match_jax():
    for mod in (JP, TP):
        pool = mod.BlockPool(6, 4, 10)
        a = pool.alloc(3)
        pool.incref(a[:2])
        assert pool.blocks_shared() == 2 and pool.bytes_in_use() == 30
        assert pool.ensure_writable(a[2]) is None  # private: write in place
        fresh = pool.ensure_writable(a[0])
        assert fresh not in a and pool.refs[a[0]] == 1 and pool.cow_copies == 1
        with pytest.raises(ValueError):
            pool.incref([5])  # never allocated
        st = mod.SlotTable(5)
        st.rows[:3] = a
        st.hi, st.shared = 3, 2
        assert st.private_blocks() == [a[2]] and st.blocks() == a


# -- CacheManager: seeding and publishing -----------------------------------

@pytest.mark.parametrize("plen,sib", [(40, 30), (32, 17), (21, 5)])
def test_cache_manager_seed_and_publish_match_jax(plen, sib):
    """The same admissions on both managers: a miss published with its
    logits (tail copied), then an exact hit, a sibling sharing ``sib``
    tokens and a request one token past the prompt. Plans, seed copies,
    tables, refcounts and stats agree."""
    rng = np.random.default_rng(plen)
    prompt = rng.integers(1, 500, plen).tolist()
    sibling = prompt[:sib] + rng.integers(1, 500, 9).tolist()
    longer = prompt + [7]
    kw = dict(append_widths=(8, 32), block=16, prefix_cache_mb=1.0)
    j = JCacheManager(JT.TransformerConfig.tiny(), 4, 96, 8, paged=True, **kw)
    t = CacheManager(TT.TransformerConfig.tiny(), 4, 96, 8, **kw)
    assert j.pool.n_blocks == t.pool.n_blocks and j.block_bytes == t.block_bytes
    for kv in (j, t):
        assert kv.lookup_seed(prompt) is None
        assert kv.admit_reserve(plen, 8, None)
        kv.attach_seed(0, None, "a", plen, 8)
        kv.ensure(0, plen + 8)
    plans = [kv.publish_plan(0, prompt, want_tail=True) for kv in (j, t)]
    assert plans[0] == plans[1] and (plans[1]["tail_dst"] >= 0) == (plen % 16 > 0)
    for kv, plan in zip((j, t), plans):
        kv.publish_commit(plan, prompt, logits="L", logits_nbytes=2048)
        kv.release_slot(0, "a")
    owners = {slot: f"r{slot}" for slot in (1, 2, 3)}
    for slot, toks in ((1, prompt), (2, sibling), (3, longer)):
        got = []
        for kv in (j, t):
            plan = kv.lookup_seed(toks)
            need = kv.reserve_need(len(toks), 8, plan)
            assert kv.admit_reserve(len(toks), 8, plan)
            info = kv.attach_seed(slot, plan, owners[slot], len(toks), 8)
            got.append((None if plan is None else plan._replace(logits=plan.logits), need, info))
        assert got[0] == got[1], (slot, got)
    np.testing.assert_array_equal(j.take_tables(), t.take_tables())
    np.testing.assert_array_equal(j.pool.refs, t.pool.refs)
    js, ts = j.stats(), t.stats()
    for key in ("blocks_in_use", "blocks_shared", "cow_copies", "prefix", "sessions"):
        assert js[key] == ts[key], key
    for kv in (j, t):
        for slot in (1, 2, 3):
            kv.release_slot(slot, owners[slot])
    np.testing.assert_array_equal(j.pool.refs, t.pool.refs)
    np.testing.assert_array_equal(t.pool.refs, _radix_refs(t.radix, t.pool.n_blocks))


def test_release_plan_and_pool_sizing_match_jax():
    kw = dict(append_widths=(8, 64), block=16, prefix_cache_mb=2.0, session_mb=3.0, host_cache_mb=8.0)
    j = JCacheManager(JT.TransformerConfig.tiny(), 4, 512, 8, paged=True, **kw)
    t = CacheManager(TT.TransformerConfig.tiny(), 4, 512, 8, **kw)
    # slots x table width, plus the retention and session budgets' blocks
    assert t.pool.n_blocks == j.pool.n_blocks == 4 * 32 + -(-(2 << 20) // t.block_bytes) + -(-(3 << 20) // t.block_bytes)
    assert t.share and t.sessions.offload.budget_bytes == 8 << 20
    prompt = list(range(1, 41))
    for kv in (j, t):
        kv.admit_reserve(40, 8, None)
        kv.attach_seed(0, None, "a", 40, 8)
        kv.ensure(0, 48)
        kv.publish_commit(kv.publish_plan(0, prompt, want_tail=False), prompt)
        kv.release_slot(0, "a")
        before = kv.pool.refs.copy()
        plan = kv.lookup_seed(prompt + [1, 2, 3])  # partial: 2 full blocks pinned
        assert plan.shared == 32 and not plan.exact
        assert (kv.pool.refs - before).sum() == 2
        kv.release_plan(plan)
        np.testing.assert_array_equal(kv.pool.refs, before)
    assert t.stats()["prefix"] == j.stats()["prefix"]


# -- device helpers ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_copy_blocks_and_gather_host_byte_equal(dtype):
    """copy_blocks (pad lanes dropped, the int8 pool's scales moved with the
    blocks) and gather_blocks_host give JAX's bytes."""
    rng = np.random.default_rng(3)
    L, NB, B, h, d = 2, 10, 4, 2, 8
    if dtype == "int8":
        k = rng.integers(-127, 128, (L, NB, B, h, d)).astype(np.int8)
        v = rng.integers(-127, 128, (L, NB, B, h, d)).astype(np.int8)
        sc = rng.random((2, L, NB, B, h)).astype(np.float32)
    else:
        k = rng.normal(size=(L, NB, B, h, d)).astype(np.float32)
        v = rng.normal(size=(L, NB, B, h, d)).astype(np.float32)
        sc = None
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[dtype]
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    jsc = None if sc is None else jnp.asarray(sc)

    def to_t(a):
        a = np.array(a)  # a writable copy
        return torch.from_numpy(a.view(np.int16) if dtype == "bfloat16" else a).view(tdt)

    def raw(t):
        t = t.contiguous()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    def jraw(a):
        a = np.asarray(a)
        return a.view(np.int16) if dtype == "bfloat16" else a

    tk, tv = to_t(jk), to_t(jv)
    tsc = None if sc is None else torch.from_numpy(sc.copy())
    srcs = np.array([3, 0, 7, 9, 3], np.int32)
    dsts = np.array([5, 1, NB, 8, NB + 4], np.int32)  # two pad lanes (dropped)
    jk2, jv2, jsc2 = JP.copy_blocks(jk, jv, jnp.asarray(srcs), jnp.asarray(dsts), scales=jsc)
    TP.copy_blocks(tk, tv, torch.from_numpy(srcs), torch.from_numpy(dsts), scales=tsc)
    np.testing.assert_array_equal(raw(tk), jraw(jk2))
    np.testing.assert_array_equal(raw(tv), jraw(jv2))
    if sc is not None:
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc2))
    # all lanes dropped: nothing changes
    before = raw(tk).copy()
    TP.copy_blocks(tk, tv, torch.from_numpy(srcs), torch.full((5,), NB, dtype=torch.int32), scales=tsc)
    np.testing.assert_array_equal(raw(tk), before)
    blocks = [8, 1, 5]
    hk, hv, hs = JP.gather_blocks_host(jk2, jv2, blocks, scales=jsc2)
    gk, gv, gs = TP.gather_blocks_host(tk, tv, blocks, scales=tsc)
    np.testing.assert_array_equal(raw(gk), jraw(hk))
    np.testing.assert_array_equal(raw(gv), jraw(hv))
    assert (gs is None) == (hs is None)
    if gs is not None:
        np.testing.assert_array_equal(gs.numpy(), hs)


# -- the engine -------------------------------------------------------------------

PREFIX_MODES = {"la1": dict(lookahead=1), "la3": dict(lookahead=3), "int8": dict(lookahead=3, kv_int8=True)}


@pytest.mark.parametrize("mode", list(PREFIX_MODES))
def test_engine_prefix_hits_match_jax(weights, mode):
    """tests/test_paged_kv.py's sequence — base, exact repeat (prefill
    skipped), a sibling sharing 20 tokens (a 16-token block-partial hit) —
    then the sibling again and a prompt one block longer than the base:
    greedy tokens and every prefix counter equal JAX's, and no pin leaks."""
    jcfg, jp, tcfg, tp = weights
    kw = PREFIX_MODES[mode]
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, prefix_cache_mb=4.0,
                  kv_int8=kw.get("kv_int8", False), **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", prefix_cache_mb=4.0, **kw, **ENGINE_KW)
    try:
        rng = np.random.default_rng(9)
        base = rng.integers(1, 512, 40).tolist()
        sib = base[:20] + rng.integers(1, 512, 10).tolist()
        longer = base + rng.integers(1, 512, 17).tolist()
        steps = []
        for i, p in enumerate((base, base, sib, sib, longer)):
            want = ref.generate(p, max_new_tokens=6)
            assert port.generate(p, max_new_tokens=6) == want, i
            steps.append(port.stats()["steps"])
        assert steps[:2] == [2, 2]  # 32 + 8 prompt tokens, then the exact hit ran no unified step
        st = port.stats()["kvcache"]["prefix"]
        assert st == ref.stats()["kvcache"]["prefix"]
        assert st["hits"] == 2 and st["partial_hits"] == 2 and st["misses"] == 1
        _assert_no_leaked_pins(port)
    finally:
        ref.close()
        port.close()


def test_concurrent_partial_and_exact_hits_match_jax(weights):
    """A shared 32-token system prompt published once, then six requests at
    once at lookahead 3 (four siblings, two exact repeats of the first
    prompt): JAX's tokens, first tokens jumping queued chunk tokens."""
    jcfg, jp, tcfg, tp = weights
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, prefix_cache_mb=4.0, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", prefix_cache_mb=4.0, **ENGINE_KW)
    try:
        rng = np.random.default_rng(21)
        system = rng.integers(1, 512, 32).tolist()
        first = system + rng.integers(1, 512, 5).tolist()
        assert port.generate(first, max_new_tokens=10) == ref.generate(first, max_new_tokens=10)
        prompts = [system + rng.integers(1, 512, n).tolist() for n in (3, 9, 17, 30)] + [first, first]
        jreqs = [ref.submit(JRequest(p, max_new_tokens=12)) for p in prompts]
        treqs = [port.submit(GenRequest(p, max_new_tokens=12)) for p in prompts]
        for jr, tr in zip(jreqs, treqs):
            assert tr.tokens() == jr.tokens()
        assert all(r.prefix_hit for r in treqs)
        st = port.stats()["kvcache"]["prefix"]
        assert st["hits"] == 2 and st["partial_hits"] == 4
        _assert_no_leaked_pins(port)
    finally:
        ref.close()
        port.close()


def test_shared_blocks_are_never_written(weights):
    """Copy-on-write: the bytes of every radix block stay unchanged across
    a sibling's whole request that shares them in place (and an exact
    repeat that copies the tail)."""
    _jcfg, _jp, tcfg, tp = weights
    with LLMEngine(tcfg, tp, device="cpu", prefix_cache_mb=4.0, **ENGINE_KW) as eng:
        rng = np.random.default_rng(5)
        base = rng.integers(1, 512, 45).tolist()
        eng.generate(base, max_new_tokens=8)
        _settled(eng)
        held = np.nonzero(_radix_refs(eng.kv.radix, eng.kv.pool.n_blocks))[0]
        snap = (eng.pool.k[:, held].clone(), eng.pool.v[:, held].clone())
        seeded: list = []
        attach = eng.kv.attach_seed

        def watch(slot, plan, *a):
            seeded.append(list(plan.blocks))
            return attach(slot, plan, *a)

        eng.kv.attach_seed = watch
        for p in (base[:40] + [3, 4, 5], base):
            eng.generate(p, max_new_tokens=30)
        _settled(eng)
        assert seeded and all(set(b) <= set(held.tolist()) for b in seeded)
        assert seeded[0] == seeded[1][:2]  # both share the base's leading blocks
        assert torch.equal(eng.pool.k[:, held], snap[0]) and torch.equal(eng.pool.v[:, held], snap[1])
        assert eng.stats()["kvcache"]["cow_copies"] == 0


def test_cancelled_exact_hit_leaves_no_pins(weights):
    _jcfg, _jp, tcfg, tp = weights
    with LLMEngine(tcfg, tp, device="cpu", prefix_cache_mb=4.0, **ENGINE_KW) as eng:
        prompt = list(range(3, 40))
        eng.generate(prompt, max_new_tokens=4)
        r = eng.submit(GenRequest(prompt, max_new_tokens=50))
        t0 = time.perf_counter()
        while r.slot is None and time.perf_counter() - t0 < 10:
            time.sleep(0.001)
        r.cancel()
        assert len(r.tokens(timeout=10)) < 50 and r.finish_reason == "cancelled" and r.prefix_hit
        assert eng.stats()["kvcache"]["prefix"]["hits"] == 1
        _assert_no_leaked_pins(eng)


def _refuse_first(eng, plen: int, log: list) -> None:
    """Make the pool refuse the first reservation of a ``plen``-token prompt
    (as a pool too full to host it would) and log every reservation."""
    reserve = eng.kv.admit_reserve
    refused = []

    def gate(n, max_new, plan):
        if n == plen and not refused:
            refused.append(n)
            log.append(("blocked", n))
            return False
        ok = reserve(n, max_new, plan)
        log.append(("reserved" if ok else "blocked", n))
        return ok

    eng.kv.admit_reserve = gate


def test_blocked_miss_lets_a_hit_behind_it_in_as_jax_does(weights):
    """Admission order: a miss the pool cannot host goes back to the head
    of the queue and the exact hit submitted behind it is admitted in the
    same pass, in both engines; the blocked request's plan leaves no pin."""
    jcfg, jp, tcfg, tp = weights
    ref = JEngine(jcfg, jp, warmup=False, kv_paged=True, prefix_cache_mb=4.0, **ENGINE_KW)
    port = LLMEngine(tcfg, tp, device="cpu", prefix_cache_mb=4.0, **ENGINE_KW)
    try:
        hit = list(range(7, 30))
        rng = np.random.default_rng(2)
        miss = hit[:16] + rng.integers(1, 512, 20).tolist()  # a partial plan pinned, then blocked
        logs = []
        for eng, Req in ((ref, JRequest), (port, GenRequest)):
            eng.generate(hit, max_new_tokens=4)
            log: list = []
            _refuse_first(eng, len(miss), log)
            # both land in the queue before the scheduler drains it
            drain = "_drain_submits" if eng is port else "_drain_and_observe"
            setattr(eng, drain, lambda *a: None)
            rm = eng.submit(Req(miss, max_new_tokens=6))
            rh = eng.submit(Req(hit, max_new_tokens=6))
            delattr(eng, drain)
            logs.append((rm.tokens(), rh.tokens(), log))
        assert logs[0] == logs[1]
        assert logs[1][2][:3] == [("blocked", len(miss)), ("reserved", len(hit)), ("reserved", len(miss))]
        _assert_no_leaked_pins(port)
    finally:
        ref.close()
        port.close()


def test_sharing_off_keeps_the_program_families(weights):
    """prefix_cache_mb=0 and session_mb=0 (the defaults): no radix, the
    step programs return tokens only, and the family names are the ones
    the engine had before sharing existed; sharing on adds kv_seed and one
    hit program per wave width."""
    _jcfg, _jp, tcfg, tp = weights
    with LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW) as off, \
            LLMEngine(tcfg, tp, device="cpu", prefix_cache_mb=1.0, **ENGINE_KW) as on:
        steps = [f"llm.step_p{s}_d8.w{w}" for s in (8, 32) for w in (1, 2, 4)]
        assert sorted(off._programs) == sorted(steps + ["llm.decode_chunk8", "llm.decode_chunk2"])
        assert off.kv.radix is None and off._hit_logits is None and off.stats()["kvcache"]["prefix"] is None
        assert sorted(on._programs) == sorted(
            list(off._programs) + ["llm.kv_seed"] + [f"llm.hit_first.w{w}" for w in (1, 2, 4)]
        )
        assert off.kv.pool.n_blocks == 4 * 6 and on.kv.pool.n_blocks > off.kv.pool.n_blocks


def test_stress_shared_prompts_sessions_and_cancels(weights):
    """More client threads than cores, a tiny interpreter switch interval,
    prompts built on three shared system prompts (repeats are exact hits),
    a third of them session turns under a device budget so small that
    sessions spill and restore while others run, and a quarter cancelled
    mid-stream: every stream ends exactly once, every token is the
    unshared engine's greedy token, and once idle no pin is left."""
    import os
    import random
    import sys
    import threading

    _jcfg, _jp, tcfg, tp = weights
    n = min(48, max(16, 2 * len(os.sched_getaffinity(0))))
    rng = random.Random(1)
    systems = [list(range(s, s + 20)) for s in (3, 50, 200)]
    prompts = [systems[i % 3] + [300 + rng.randint(0, 5) for _ in range(rng.randint(1, 12))] for i in range(n)]
    for i in range(7, n, 5):
        prompts[i] = prompts[i - 7]  # a repeat: an exact hit once the first is published
    new = [4 + (5 * i) % 13 for i in range(n)]
    with LLMEngine(tcfg, tp, device="cpu", **ENGINE_KW) as plain:
        want = {tuple(p): plain.generate(p, max_new_tokens=16) for p in {tuple(p): p for p in prompts}.values()}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with LLMEngine(tcfg, tp, device="cpu", prefix_cache_mb=0.5, session_mb=0.01, **ENGINE_KW) as eng:
            reqs = [GenRequest(p, max_new_tokens=new[i], session_id=f"s{i % 4}" if i % 3 == 0 else "")
                    for i, p in enumerate(prompts)]
            ends = {id(r): 0 for r in reqs}
            got = {id(r): [] for r in reqs}

            def client(r, cancel_after):
                eng.submit(r)
                while True:
                    item = r.out.get(timeout=120)
                    if item is None:
                        ends[id(r)] += 1
                        return
                    got[id(r)].extend(item)
                    if cancel_after is not None and len(got[id(r)]) >= cancel_after:
                        r.cancel()

            threads = [
                threading.Thread(target=client, args=(r, rng.randint(1, 3) if i % 4 == 1 else None))
                for i, r in enumerate(reqs)
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            assert not any(th.is_alive() for th in threads)
            for r in reqs:
                assert ends[id(r)] == 1 and r.out.qsize() == 0
                assert got[id(r)] == want[tuple(r.prompt_tokens)][: len(got[id(r)])]
                assert r.finish_reason == "cancelled" or len(got[id(r)]) == r.max_new_tokens
            assert eng.stats()["kvcache"]["prefix"]["partial_hits"]
            _assert_no_leaked_pins(eng)
    finally:
        sys.setswitchinterval(old)
