#!/usr/bin/env python3
"""Per-stage decomposition of routed SpMV at distributed-shard scale.

This script isolates every stage of `spmv_routed` (ops/rspmv.py) for the
heaviest shard of an n-way split of the webbase proxy, on the device, so
per-shard overhead is attributed to the stage where it lives.

Stages timed independently (each as its own fori_loop program, plans
passed as loop args per CLAUDE.md):
  full        the whole spmv_routed call
  xroute      balanced-relabel x permutation (apply_route, N_x)
  gather      slab-bucket gather (+ peel contribution)
  mainroute   gather order -> lane stack (apply_route, route_n)
  segsum      sorted block segment_sum over the stack
  unrank      rank order -> row order (apply_route, unrank_n)
  epilogue    beta*y + alpha*ax

Run on the GPU, fresh process, no env overrides:
    python experiments/shard_decompose.py [n_shards ...]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    import jax
    import jax.numpy as jnp

    from sblas.containers import DenseVector
    from sblas.io.generate import webbase_like
    from sblas.io.plancache import cached_plan
    from sblas.ops.route import apply_route
    from sblas.ops.rspmv import RoutedPlan, spmv_routed, \
        _gathered_contrib
    from sblas.parallel.xfoot import xfoot_worst_local
    from sblas.utils.benchtime import dispatch_overhead_ms, \
        loop_time2_ms

    print(f"# device {jax.devices()[0]}, dispatch "
          f"{dispatch_overhead_ms():.2f} ms", file=sys.stderr)
    W = webbase_like(dtype=np.float32)
    chips = [int(a) for a in sys.argv[1:]] or [16, 4]

    for nsh in chips:
        local, (tg, srs, prs, sks) = xfoot_worst_local(W, nsh)
        cache = os.path.join(".bench_cache",
                             f"webbase_xfoot_shard{nsh}_f32_v1.npz")
        plan = cached_plan(
            cache,
            lambda: RoutedPlan.from_csr(local, dtype=jnp.float32,
                                        min_gtiles=tg, min_srows=srs,
                                        min_prows=prs, min_sranks=sks),
            valid=lambda p: (p.shape == local.shape
                             and p.nnz == local.nnz))

        print(f"\n== n={nsh}: shard {local.shape}, nnz {local.nnz}, "
              f"T_g {plan.n_gtiles}, S {plan.n_srows}, R_p {plan.n_prows}, "
              f"route_n {plan.route_n}, xroute_n {plan.xroute_n}, "
              f"unrank_n {plan.unrank_n}")

        x = jnp.asarray(
            DenseVector.random(local.shape[1], dtype=np.float32).values)
        y = jnp.zeros(local.shape[0], jnp.float32)

        def t(name, step, carry, args):
            # two-point estimator: the one-point form measured 19 us
            # stages as 0.0 here (256 iters of signal vs the per-process
            # dispatch-constant noise — see benchtime.loop_time2_ms)
            ms = loop_time2_ms(step, carry, iters=2048, args=args)
            print(f"  {name:<10} {ms * 1e3:8.1f} us")
            return ms

        def full(yc, p, xv):
            return spmv_routed(p, xv + 1e-6 * yc[0], 1.0, 1.0, yc)

        t_full = t("full", full, y, (plan, x))

        if plan.xroute_n:
            xpad = jnp.pad(x, (0, plan.xroute_n - x.shape[0]))

            def xroute(c, p):
                return apply_route(p.xroute_schedule, c, p.xroute_tables)

            t("xroute", xroute, xpad, (plan,))

        def gather(c, p):
            # carry is x (same length); nonzero coupling via the carry
            out = _gathered_contrib(p, c)
            if p.n_prows:
                xp = jnp.take(c, p.prow_col, axis=0).astype(out.dtype)
                pc = p.pvals.astype(out.dtype) * xp[:, None]
                out = jnp.concatenate([out, pc.reshape(-1)])
            return (c + 1e-9 * out[0]).astype(c.dtype)

        t("gather+peel", gather, x, (plan,))

        contrib = jnp.zeros(plan.route_n, jnp.float32)

        def mainroute(c, p):
            return apply_route(p.schedule, c, p.tables)

        t("mainroute", mainroute, contrib, (plan,))

        # bf16 TRANSPORT: half-width values + int16 tables on the
        # HBM-bound passes (with_transport re-aims the cached f32 plan)
        plan16 = plan.with_transport("bf16")
        contrib16 = jnp.zeros(plan16.route_n, jnp.bfloat16)

        def mainroute16(c, p):
            return apply_route(p.schedule, c, p.tables)

        try:
            t("mainrt-bf16", mainroute16, contrib16, (plan16,))

            def full16(yc, p, xv):
                return spmv_routed(p, xv + 1e-6 * yc[0], 1.0, 1.0, yc)

            t("full-bf16", full16, y, (plan16, x))
        except Exception as e:
            print(f"  mainrt-bf16 FAILED: {type(e).__name__}: "
                  f"{str(e)[:160]}")

        stack = jnp.zeros((plan.n_srows, 128), jnp.float32)

        def segsum(c, p):
            blocks = jax.ops.segment_sum(c, p.brow_ids,
                                         num_segments=p.n_blocks,
                                         indices_are_sorted=True)
            return c + 1e-9 * blocks[0, 0]

        t("segsum", segsum, stack, (plan,))

        yr = jnp.zeros(plan.unrank_n, jnp.float32)

        def unrank(c, p):
            return apply_route(p.unrank_schedule, c, p.unrank_tables)

        t("unrank", unrank, yr, (plan,))

        def epi(c, p):
            return 0.5 * c + 0.5 * c * 1.000001

        t("epilogue", epi, y, (plan,))

        print(f"  (full = {t_full * 1e3:.1f} us; stages above may overlap "
              f"in the fused program — the sum is an upper bound)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
