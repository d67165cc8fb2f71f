from .acq import (CEI, EI, LCB, MACE, PI, UCB, AcqParams, Acquisition, AddLCB, GeneralAcq, Mean,
                  MOMeanSigmaLCB, Sigma, ThompsonSampling, log_ei, log_pi)

__all__ = ["AcqParams", "Acquisition", "LCB", "UCB", "Mean", "Sigma", "EI", "PI", "MACE",
           "ThompsonSampling", "CEI", "AddLCB", "MOMeanSigmaLCB", "GeneralAcq", "log_ei", "log_pi"]
