from .base import AbstractOptimizer
from .bo import BO
from .cmaes import CMAES
from .evolution import Evolution
from .general import GeneralBO
from .hebo import HEBO
from .hebo_contextual import HEBO_VectorContextual
from .hebo_embedding import HEBO_Embedding, gen_emb_space, gen_proj_matrix
from .noisy_opt import NoisyAcq, NoisyOpt
from .nomr import AbsEtaDifference, NoMR_BO
from .util import parse_space_from_bayesmark
from .baselines import HillClimbing, LineBO, MultiArmedBandit, RandomSearch, SimulatedAnnealing
from .bo_builder import BO_ALGOS, BoBuilder, MCBOptimizer
from .antbo import AntBOOptimizer, CasmopolitanCat
from .safeopt import SafeOpt
from .subdomain import AscentLineBO, CoordinateLineBO, RandomLineBO, SubDomainBO
from .macebo import MACEBO

__all__ = [
    "AbstractOptimizer", "BO", "CMAES", "Evolution", "GeneralBO", "HEBO", "HEBO_VectorContextual",
    "HEBO_Embedding", "gen_emb_space", "gen_proj_matrix", "NoisyAcq", "NoisyOpt",
    "AbsEtaDifference", "NoMR_BO", "parse_space_from_bayesmark", "HillClimbing", "LineBO",
    "MultiArmedBandit", "RandomSearch", "SimulatedAnnealing", "BO_ALGOS", "BoBuilder",
    "MCBOptimizer", "AntBOOptimizer", "CasmopolitanCat", "SafeOpt", "AscentLineBO",
    "CoordinateLineBO", "RandomLineBO", "SubDomainBO", "MACEBO",
]
