"""End-to-end d=32 rank-30 QTT Poisson ALS solve on a GPU — the BASELINE.md
north-star workload, measured as a FULL solve (not per-half-sweep):

  phase 1  f32: N1 alternating half-sweeps + per-sweep residuals, ONE XLA
           program / ONE dispatch (ops.make_als_multi_sweep_res)
  phase 2  df32 (double-word f32, f64 quality): N2 chained half-sweeps,
           ONE program / ONE dispatch (ops.make_df_als_multi_sweep)

The wall-clock covers both dispatches; the initial host->device upload
and the final download + host-f64 residual verification are timed
separately (BASELINE.md: host transfer excluded from the loop).

Usage: python -u benchmarks/poisson_solve_e2e.py [n1] [n2]
"""
import os
import sys
import time

os.environ.setdefault("XERUS_TPU_NO_X64", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from xerus_tpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

D = int(os.environ.get("E2E_D", 32))
RANK = int(os.environ.get("E2E_RANK", 30))
_pos = [a for a in sys.argv[1:] if not a.startswith("--")]
N1 = int(_pos[0]) if len(_pos) > 0 else 8
N2 = int(_pos[1]) if len(_pos) > 1 else 3

rng = np.random.Generator(np.random.PCG64(0xBAADF00D))

# ---- problem build (host, f64) ----
xs = []
for i in range(D):
    rl = 1 if i == 0 else min(RANK, 2 ** i, 2 ** (D - i))
    rr = 1 if i == D - 1 else min(RANK, 2 ** (i + 1), 2 ** (D - i - 1))
    xs.append(rng.normal(size=(rl, 2, rr)) / np.sqrt(RANK))
for i in range(D - 1, 0, -1):      # right-canonicalize (core at 0)
    rl, n, rr = xs[i].shape
    q, r = np.linalg.qr(xs[i].reshape(rl, n * rr).T)
    xs[i] = q.T.reshape(q.shape[1], n, rr)
    xs[i - 1] = np.einsum("anb,bk->ank", xs[i - 1], r.T)

L = 2.0 * np.eye(2) - np.eye(2, k=1) - np.eye(2, k=-1)
I = np.eye(2)
A64 = []
for i in range(D):
    core = np.zeros((1 if i == 0 else 2, 2, 2, 1 if i == D - 1 else 2))
    if i == 0:
        core[0, :, :, 0] = L
        core[0, :, :, 1] = I
    elif i == D - 1:
        core[0, :, :, 0] = I
        core[1, :, :, 0] = L
    else:
        core[0, :, :, 0] = I
        core[1, :, :, 0] = L
        core[1, :, :, 1] = I
    A64.append(core)
b64 = [np.ones((1, 2, 1)) for _ in range(D)]

from xerus_tpu.ops.tt_kernels import make_als_multi_sweep_res
from xerus_tpu.ops.mixed_precision import make_df_als_multi_sweep
from xerus_tpu.ops.df32 import df_from_f64, df_to_f64

# ---- upload (excluded from the solve wall) ----
t0 = time.perf_counter()
x32 = tuple(jnp.asarray(c.astype(np.float32)) for c in xs)
A32 = tuple(jnp.asarray(c.astype(np.float32)) for c in A64)
b32 = tuple(jnp.asarray(c.astype(np.float32)) for c in b64)
x_df = tuple(df_from_f64(c) for c in xs)
A_df = tuple(df_from_f64(c) for c in A64)
b_df = tuple(df_from_f64(c) for c in b64)
jax.block_until_ready(x32)
t_upload = time.perf_counter() - t0
print("upload: %.2f s" % t_upload, flush=True)

shapes_key = tuple(tuple(c.shape) for c in x32)
FUSED = "--staged" not in sys.argv
if not FUSED:
    # SMALL programs (2 half-sweeps each), dispatched repeatedly: each
    # extra sweep-in-program lengthens the compile
    fn1 = make_als_multi_sweep_res(shapes_key, "float32", 2)
    fn2 = make_df_als_multi_sweep(shapes_key, "float32", 2)

    # df-phase seeding as ONE jitted program: per-core .astype/zeros_like
    # would be 2*D tiny un-jitted dispatches
    seed_df = jax.jit(lambda cs: tuple((c.astype(jnp.float32),
                                        jnp.zeros_like(c)) for c in cs))

    # ---- compile (warm the programs once; excluded, reported) ----
    t0 = time.perf_counter()
    c_out, res_hist = fn1(x32, A32, b32)
    float(res_hist[-1])
    t_c1 = time.perf_counter() - t0
    print("phase1 compile+first-run: %.1f s" % t_c1, flush=True)
    t0 = time.perf_counter()
    w = fn2(tuple((h, l) for h, l in x_df), A_df, b_df)
    float(jnp.sum(w[0][0]))
    t_c2 = time.perf_counter() - t0
    print("phase2 compile+first-run: %.1f s" % t_c2, flush=True)
    jax.block_until_ready(seed_df(x32))  # warm the seed program too
if FUSED:
    # the WHOLE solve as ONE program: f32 while_loop to the plateau
    # (same 3x-per-sweep auto-stop, in-program, even-count stops) +
    # in-program df seed + df finish (ops/mixed_precision.py)
    from xerus_tpu.ops.mixed_precision import make_als_f32_df_run
    run = make_als_f32_df_run(shapes_key, "float32", N1,
                              2 * ((N2 + 1) // 2))
    t0 = time.perf_counter()
    c2f, hist_f, cnt = run(x32, A32, b32, A_df, b_df)
    float(jnp.sum(c2f[0][0]))
    t_cf = time.perf_counter() - t0
    print("fused compile+first-run: %.1f s" % t_cf, flush=True)

    t0 = time.perf_counter()
    c2, hist_arr, cnt = run(x32, A32, b32, A_df, b_df)
    cnt = int(cnt)                            # the ONLY sync of the solve
    t_solve = time.perf_counter() - t0
    hist = [float(v) for v in np.asarray(hist_arr)[:cnt]]
    print("f32 residual history:", hist, flush=True)
    print("SOLVE WALL (%d f32 + %d df half-sweeps, ONE program/dispatch): "
          "%.3f s" % (cnt, 2 * ((N2 + 1) // 2), t_solve), flush=True)
else:
    # ---- the measured solve: fresh start, warm programs ----
    t0 = time.perf_counter()
    c1 = x32
    hist = []
    for _ in range((N1 + 1) // 2):
        c1, res_hist = fn1(c1, A32, b32)
        hist += [float(v) for v in res_hist]  # sync per call (2 sweeps)
        if len(hist) >= 4 and hist[-1] > 0.3 * hist[-3]:
            break   # no longer improving 3x per sweep: f32 floor reached
    # seed the df phase with the f32 result (hi = f32 cores, lo = 0)
    c2 = seed_df(c1)
    for _ in range((N2 + 1) // 2):
        c2 = fn2(c2, A_df, b_df)
    float(jnp.sum(c2[0][0]))                  # final sync
    t_solve = time.perf_counter() - t0
    print("f32 residual history:", hist, flush=True)
    print("SOLVE WALL (%d f32 + %d df half-sweeps, 2-sweep programs): %.3f s"
          % (len(hist), 2 * ((N2 + 1) // 2), t_solve), flush=True)

# ---- download + host-f64 verification (excluded, reported) ----
t0 = time.perf_counter()
sol = [df_to_f64(h, l) for (h, l) in c2]
t_down = time.perf_counter() - t0


def host_residual(xc):
    z = []
    d = len(xc)
    for k in range(d):
        ax = np.einsum("amnb,unU->aumbU", A64[k], xc[k]).reshape(
            A64[k].shape[0] * xc[k].shape[0], 2, -1)
        bc = b64[k]
        if k == 0:
            z.append(np.concatenate([ax, -bc], axis=2))
        elif k == d - 1:
            z.append(np.concatenate([ax, bc], axis=0))
        else:
            al, m, ar = ax.shape
            bl, _, br = bc.shape
            top = np.concatenate([ax, np.zeros((al, m, br))], axis=2)
            bot = np.concatenate([np.zeros((bl, m, ar)), bc], axis=2)
            z.append(np.concatenate([top, bot], axis=0))

    def log_norm(cores):
        R = np.ones((1, 1))
        logs = 0.0
        for c in cores[:-1]:
            k2, _, rr = (R.shape[0], None, c.shape[2])
            cur = np.einsum("ka,anb->knb", R, c).reshape(-1, c.shape[2])
            _, R = np.linalg.qr(cur)
            nrm = np.linalg.norm(R)
            logs += np.log(max(nrm, 1e-300))
            R = R / nrm
        last = np.einsum("ka,anb->knb", R, cores[-1])
        return logs + np.log(max(np.linalg.norm(last), 1e-300))

    return np.exp(log_norm(z) - log_norm(b64))


res_final = host_residual(sol)
print("download: %.2f s  host-f64 relative residual: %.3e"
      % (t_down, res_final), flush=True)
