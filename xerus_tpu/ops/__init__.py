from .tt_kernels import (tt_round_sweep, make_round_sweep, round_flops,
                         tt_round_sweep_uniform, make_round_sweep_scan,
                         tt_round_randomized, tt_round_randomized_uniform,
                         tt_round_streaming_uniform, tt_round_eps_fast,
                         tt_round_sweep_segmented, tt_residual_rel,
                         make_als_sweep_res, make_als_multi_sweep_res,
                         randomized_round_flops,
                         make_als_sweep, als_sweep_flops,
                         als_half_sweep_batched, make_timed_loop, pad_cores)
from .apply_kernels import (apply_operator_rounded,
                            apply_operator_rounded_cores)
from .sparse_kernels import sparse_times_dense, dense_times_sparse
from . import df32
from . import mixed_precision
from .dmrg_kernels import dmrg_groundstate_fast
from .adf_kernels import make_adf_iteration
from .ozaki import ozaki_matmul, ozaki_matmul_f32
from .df_cholesky import df_cholesky, df_solve_spd_chol
from .df_eigh import df_eigh, df_svd, df_svd_jw
from .df_rounding import tt_round_df, tt_round_df_from_f64
