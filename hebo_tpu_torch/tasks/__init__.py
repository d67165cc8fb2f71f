from .antbo_tools import AA_ALPHABET, AbsolutTool, ManualTool, TableFillingTool

__all__ = ["AA_ALPHABET", "AbsolutTool", "ManualTool", "TableFillingTool"]
