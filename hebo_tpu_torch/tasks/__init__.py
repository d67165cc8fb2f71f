"""Black-box tasks (port of ``hebo_tpu/tasks``): the same names as the JAX
package's ``tasks/__init__.py``.  The tasks are host numpy; the device work
is ``DrillsBaseline``'s agent and ``hpob.run_hpob_eval``'s default HEBO, both
on ``device``.  ``lasso`` and ``ml_tuning`` import sklearn when a task is
evaluated."""

from .synthetic import (
    Ackley, Branin, Hartmann6, Levy, Rosenbrock, Schwefel, StyblinskiTang,
    SyntheticTask, get_task,
)
from .eda import EDASeqOptTask, random_aag
from .pest import PestControlTask
from .rna import RNAInverseFoldTask, nussinov_fold
from .boils import BoilsTask, SynthesisSession
from .hpob import SyntheticHPOBTask, TabularBenchmark
from .lasso import LassoBenchTask
from .bayesmark import BayesmarkTask
from .ml_tuning import SVMTuningTask, XGBTuningTask
from .highdim import NASBenchTask, LPSolveTask, parse_mps
from .antbo_tools import AbsolutTool, TableFillingTool, ManualTool, AA_ALPHABET
from .robust import (
    RKHSTask, RobotPushTask, CorruptedTask, UncertainEvalWrapper, rkhs_synth,
)
from .drills import DrillsBaseline
