"""Measure the three extension-window formulations on the current backend.

Run:  python benchmarks/ext_variants.py
"""
import sys, os, time
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from npge_tpu.util.jaxcache import enable_compilation_cache
enable_compilation_cache()

from functools import partial
import numpy as np
import jax
import jax.numpy as jnp

from npge_tpu.ops.extend import (
    bases_for_groups, extend_chunk, extend_chunk_rows,
    make_codes2, make_codes2_rows,
)


def timed(loop, args, cells, n1=5, n2=25):
    for n in (n1, n2):
        np.asarray(loop(*args, n=n))
    t1 = time.perf_counter(); np.asarray(loop(*args, n=n1)); t1 = time.perf_counter() - t1
    t2 = time.perf_counter(); np.asarray(loop(*args, n=n2)); t2 = time.perf_counter() - t2
    return cells / max((t2 - t1) / (n2 - n1), 1e-9)


def main():
    rng = np.random.default_rng(0)
    T_half = 2_000_000
    half = rng.integers(0, 4, T_half).astype(np.uint8)
    other = half.copy()
    m = rng.random(T_half) < 0.02
    other[m] = (other[m] + rng.integers(1, 4, m.sum())) % 4
    codes = np.concatenate([half, other])
    B, F, CHUNK = 8192, 2, 512
    starts = rng.integers(1000, T_half - CHUNK - 1000, B).astype(np.int32)
    lo = np.stack([starts, starts + T_half], axis=1).astype(np.int32)
    hi = lo + 21
    ori = np.ones((B, F), np.int32)
    fmask = np.ones((B, F), bool)
    cap = np.full((B, F), CHUNK, np.int32)
    T = len(codes)
    codes_dev = jnp.asarray(codes)
    codes2 = make_codes2(codes_dev)
    codes2_rows = make_codes2_rows(codes_dev)
    _, base_r = bases_for_groups(lo, hi, ori, T)
    base_r = jnp.asarray(base_r)
    fmask_d = jnp.asarray(fmask)
    cap_d = jnp.asarray(cap)
    cells = B * F * CHUNK

    @partial(jax.jit, static_argnames=("n",))
    def loop_byte(codes2, base, fmask, cap, n):
        def body(i, acc):
            z = jnp.zeros(B, jnp.int32)
            ext, _, _ = extend_chunk(codes2, base + i, fmask, cap, z, z, 9, 10, CHUNK)
            return acc + ext.sum()
        return jax.lax.fori_loop(0, n, body, jnp.int32(0))

    @partial(jax.jit, static_argnames=("n",))
    def loop_rows(rows, base, fmask, cap, n):
        def body(i, acc):
            z = jnp.zeros(B, jnp.int32)
            ext, _, _ = extend_chunk_rows(rows, 2 * T, base + i, fmask, cap, z, z, 9, 10, CHUNK)
            return acc + ext.sum()
        return jax.lax.fori_loop(0, n, body, jnp.int32(0))

    r = {}
    r["byte_gather"] = timed(loop_byte, [codes2, base_r, fmask_d, cap_d], cells)
    r["row_gather"] = timed(loop_rows, [codes2_rows, base_r, fmask_d, cap_d], cells)

    # pallas (module removed — see COMPONENTS.md FragmentsExtender row;
    # this block stays so a future reintroduction is measured the same way)
    try:
        from npge_tpu.ops.extend_pallas import extend_chunk_pallas
        codes2_pad = jnp.concatenate(
            [codes2, jnp.full(CHUNK + 64, 4, jnp.uint8)])

        @partial(jax.jit, static_argnames=("n",))
        def loop_pallas(codes2p, base, fmask, cap, n):
            def body(i, acc):
                z = jnp.zeros(B, jnp.int32)
                ext, _, _ = extend_chunk_pallas(
                    codes2p, base + i, fmask, cap, z, z, 9, 10, CHUNK, GB=8)
                return acc + ext.sum()
            return jax.lax.fori_loop(0, n, body, jnp.int32(0))

        # parity first
        z = jnp.zeros(B, jnp.int32)
        want = extend_chunk(codes2, base_r, fmask_d, cap_d, z, z, 9, 10, CHUNK)
        got = extend_chunk_pallas(codes2_pad, base_r, fmask_d, cap_d, z, z, 9, 10, CHUNK, GB=8)
        ok = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(want, got))
        r["pallas_parity"] = ok
        r["pallas_dma"] = timed(loop_pallas, [codes2_pad, base_r, fmask_d, cap_d], cells)
    except Exception as e:
        r["pallas_error"] = repr(e)[:500]

    print(jax.devices())
    for k, v in r.items():
        if isinstance(v, float):
            print(f"{k:16s} {v/1e9:10.3f} Gcells/s")
        else:
            print(f"{k:16s} {v}")


if __name__ == "__main__":
    main()
