from .performance_data import PerformanceData, NoPerfData, DataPoint
from .als import (ALSVariant, ALS, ALS_SPD, ALS_SPD_CG, DMRG, DMRG_SPD, ASD, ASD_SPD)
from .measurements import SinglePointMeasurementSet, RankOneMeasurementSet
from .adf import ADFVariant, ADF
from .retractions import (TTTangentVector, HOSVDRetractionI, HOSVDRetractionII,
                          ALSRetractionI, ALSRetractionII,
                          SubmanifoldRetractionI, SubmanifoldRetractionII,
                          ProjectiveVectorTransport, TTRetractionI,
                          TTRetractionII, TTVectorTransport)
from .steepest_descent import SteepestDescentVariant, SteepestDescent, line_search
from .cg import GeometricCGVariant, GeometricCG
from .iht import IHT
from .decomposition_als import decomposition_als
from .largest_entry import find_largest_entry
from .uq_adf import (UQMeasurementSet, uq_adf, uq_avg, uq_mc,
                     randvar_to_position)
from .eigensolver import (EigenALSVariant, DMRG_groundstate, ALS_groundstate,
                          smallest_eigenvalue)
from .random_svd import randomTTSVD


def als_spd_mixed(A, x, b, num_half_sweeps: int = 6):
    """Mixed-precision (double-word f32) SPD ALS: float64-quality residuals
    from float32 compute only (ops/mixed_precision.py).  Returns the
    solution as a TTTensor built from the refined cores."""
    from ..ops.mixed_precision import als_spd_mixed as _impl
    from ..tt.ttnetwork import TTTensor
    from ..core.tensor import Tensor
    cores = _impl(A, x, b, num_half_sweeps)
    return TTTensor._make([Tensor.from_ndarray(c) for c in cores])


def als_spd_fused(A, x, b, max_f32_sweeps: int = 16, df_sweeps: int = 2):
    """Full mixed-precision SPD solve as ONE device program: f32
    while_loop half-sweeps to the f32 plateau, in-program double-word
    seed, then ``df_sweeps`` df half-sweeps — f64-quality residuals in
    one dispatch (ops/mixed_precision.make_als_f32_df_run).
    Returns (solution TTTensor, f32 residual history list)."""
    import numpy as np
    from ..config import host
    from ..ops.mixed_precision import (make_als_f32_df_run, df_from_f64,
                                       df_to_f64)
    from ..tt.ttnetwork import TTTensor
    from ..core.tensor import Tensor
    import jax.numpy as jnp

    x = x.copy()
    with host():   # object-level f64 prep stays off the accelerator
        from ..config import require
        # Cholesky-based local solves throughout: symmetric operators only
        # (general operators: xe.ALS_SPD auto-selects LU local solves)
        require(A.is_symmetric(),
                "als_spd_fused requires a symmetric operator; "
                "use xe.ALS_SPD for general operators")
        x.move_core(0)
        x_np = [np.asarray(c.to_ndarray(), np.float64) for c in x.components]
        A_np = [np.asarray(c.to_ndarray(), np.float64) for c in A.components]
        b_np = [np.asarray(c.to_ndarray(), np.float64) for c in b.components]
    x32 = tuple(jnp.asarray(c.astype(np.float32)) for c in x_np)
    A32 = tuple(jnp.asarray(c.astype(np.float32)) for c in A_np)
    b32 = tuple(jnp.asarray(c.astype(np.float32)) for c in b_np)
    A_df = tuple(df_from_f64(c) for c in A_np)
    b_df = tuple(df_from_f64(c) for c in b_np)
    run = make_als_f32_df_run(tuple(tuple(c.shape) for c in x32),
                              "float32", int(max_f32_sweeps),
                              int(df_sweeps))
    out, hist, cnt = run(x32, A32, b32, A_df, b_df)
    cnt = int(cnt)
    hist = [float(v) for v in np.asarray(hist)[:cnt]]
    cores = [df_to_f64(np.asarray(h), np.asarray(l)) for (h, l) in out]
    return (TTTensor._make([Tensor.from_ndarray(c) for c in cores]),
            hist)
