"""xerus_tpu — a JAX library for higher-order tensors, Tensor-Train /
MPS decompositions and general tensor networks.

Ground-up JAX/XLA re-design with the capabilities of the reference C++
library xerus v3.0.1 (YiZhiXiaoGuLI/xerus): indexed expressions with lazy
evaluation and cached contraction paths, dense + sparse tensors, generic
tensor networks, TT/MPS with canonicalization and rounding, and optimization
algorithms (ALS/DMRG/ASD, ADF completion, Riemannian CG/SD, IHT, ...).
"""

from . import config as _config_module
from .config import config, EPSILON, set_value_dtype, value_dtype, host

from .core import (Tensor, Representation, Initialisation, reshuffle,
                   approx_equal, approx_entrywise_equal,
                   contract, calculate_svd, calculate_qr, calculate_rq,
                   calculate_qc, calculate_cq, pseudo_inverse, solve,
                   solve_least_squares)
from .core import entrywise_product as _tensor_entrywise_product
from .indexing import Index, indices, SVD, QR, RQ, QC, CQ
from .indexing import Factorisation as TensorFactorisation
from .network import TensorNetwork, TensorNode
from .network import Link as TensorNetworkLink
from .tt import (TTNetwork, TTTensor, TTOperator, dyadic_product,
                 apply_operator)
from .tt import entrywise_product as _tt_entrywise_product


def entrywise_product(a, b):
    """Hadamard product for Tensors or TT networks (overloaded like the
    reference's xerus::entrywise_product)."""
    if isinstance(a, TTNetwork):
        return _tt_entrywise_product(a, b)
    return _tensor_entrywise_product(a, b)
from .misc import (FileFormat, save_to_file, load_from_file, LogHistogram,
                   set_seed, log, xethrow)
from .core import serialization as _serialization  # registers Tensor I/O

from .algorithms import (PerformanceData, NoPerfData, DataPoint, ALSVariant, ALS,
                         ALS_SPD, ALS_SPD_CG, DMRG, DMRG_SPD, ASD, ASD_SPD,
                         SinglePointMeasurementSet, RankOneMeasurementSet,
                         ADFVariant, ADF, TTTangentVector,
                         HOSVDRetractionI, HOSVDRetractionII, ALSRetractionI,
                         ALSRetractionII, SubmanifoldRetractionI,
                         SubmanifoldRetractionII, ProjectiveVectorTransport,
                         TTRetractionI, TTRetractionII, TTVectorTransport,
                         SteepestDescentVariant, SteepestDescent,
                         GeometricCGVariant, GeometricCG, IHT,
                         decomposition_als, find_largest_entry,
                         UQMeasurementSet, uq_adf, uq_avg, uq_mc,
                         EigenALSVariant, DMRG_groundstate, ALS_groundstate,
                         smallest_eigenvalue, als_spd_mixed, als_spd_fused,
                         randomTTSVD)
from . import examples

from .core.tensor import Tensor as _T


def frob_norm(x) -> float:
    return x.frob_norm()


def one_norm(x) -> float:
    return x.one_norm()


from .warmup import warmup
from .ops.dmrg_kernels import dmrg_solve

__version__ = "0.1.0"
from . import models
