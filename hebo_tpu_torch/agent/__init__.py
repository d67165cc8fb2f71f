from .core import (
    ActCommand, Agent, AgentMemory, Command, DecideCommand, DecisionFlow,
    LoopFlow, SequentialFlow, ThinkCommand,
)
from .llm import HFBackend, MockLLM
from .logger import EpisodeLogger
from .parsers import parse_action, parse_final_answer
from .tasks import (
    AlfWorldStyleTask, GridWorldTask, GSM8KStyleTask, HotpotQAStyleTask,
    HumanEvalStyleTask, TextTask, WebShopStyleTask,
)
