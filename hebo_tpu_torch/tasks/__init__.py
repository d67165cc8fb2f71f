from .antbo_tools import AA_ALPHABET, AbsolutTool, ManualTool, TableFillingTool
from .bayesmark import BayesmarkTask
from .pest import PestControlTask

__all__ = ["AA_ALPHABET", "AbsolutTool", "ManualTool", "TableFillingTool", "PestControlTask",
           "BayesmarkTask"]
