"""LLM-agent command/flow engine.

Parity: the reference Agent project (its src/agent/, 15,676 LoC): the
command/flow abstraction (commands/{core,flows,actions,tool_use}.py) —
an agent executes a *flow* (sequential / decision / loop composition of
commands); commands either call the LLM (think, decide, act) or interact
with the task environment; prompts are built from structured memory and
LLM outputs are parsed into actions.

Model-agnostic: the LLM is a callable ``str -> str`` (see
hebo_tpu_torch.agent.llm for mock and HF-transformers backends).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "AgentMemory",
    "Command",
    "ThinkCommand",
    "ActCommand",
    "DecideCommand",
    "SequentialFlow",
    "DecisionFlow",
    "LoopFlow",
    "Agent",
]


@dataclass
class AgentMemory:
    """Structured episodic memory: observation/thought/action triples."""

    task_description: str = ""
    steps: List[Dict[str, str]] = field(default_factory=list)
    scratch: Dict[str, Any] = field(default_factory=dict)

    def add(self, kind: str, content: str):
        self.steps.append({"kind": kind, "content": content, "t": str(time.time())})

    def transcript(self, last_n: int = 16) -> str:
        lines = [f"Task: {self.task_description}"]
        for s in self.steps[-last_n:]:
            lines.append(f"[{s['kind']}] {s['content']}")
        return "\n".join(lines)


class Command:
    """One node of a flow; ``execute`` may call the LLM and/or the env."""

    name = "command"

    def execute(self, agent: "Agent") -> Optional[str]:
        raise NotImplementedError


class ThinkCommand(Command):
    name = "think"

    def __init__(self, prompt_suffix: str = "Think step by step about what to do next."):
        self.prompt_suffix = prompt_suffix

    def execute(self, agent):
        prompt = agent.memory.transcript() + "\n" + self.prompt_suffix
        thought = agent.llm(prompt)
        agent.memory.add("thought", thought)
        return thought


class ActCommand(Command):
    """Ask the LLM for an action, parse it, step the environment."""

    name = "act"

    def __init__(self, parser: Optional[Callable[[str], str]] = None):
        from .parsers import parse_action

        self.parser = parser or parse_action

    def execute(self, agent):
        prompt = (
            agent.memory.transcript()
            + "\nAvailable actions: "
            + ", ".join(agent.env.available_actions())
            + '\nRespond with: Action: <action>'
        )
        raw = agent.llm(prompt)
        action = self.parser(raw)
        obs, reward, done = agent.env.step(action)
        agent.memory.add("action", action)
        agent.memory.add("observation", obs)
        agent.last_reward = reward
        agent.done = agent.done or done
        return action


class DecideCommand(Command):
    """LLM multiple-choice decision among labeled options."""

    name = "decide"

    def __init__(self, question: str, options: Sequence[str]):
        self.question = question
        self.options = list(options)

    def execute(self, agent):
        prompt = (
            agent.memory.transcript()
            + f"\n{self.question}\nOptions: "
            + ", ".join(self.options)
            + "\nAnswer with exactly one option."
        )
        raw = agent.llm(prompt).strip().lower()
        for opt in self.options:
            if opt.lower() in raw:
                agent.memory.add("decision", opt)
                return opt
        agent.memory.add("decision", self.options[0])
        return self.options[0]


class SequentialFlow(Command):
    name = "sequence"

    def __init__(self, commands: Sequence[Command]):
        self.commands = list(commands)

    def execute(self, agent):
        out = None
        for c in self.commands:
            if agent.done:
                break
            out = c.execute(agent)
        return out


class DecisionFlow(Command):
    """Branch on a DecideCommand's answer."""

    name = "decision"

    def __init__(self, decide: DecideCommand, branches: Dict[str, Command]):
        self.decide = decide
        self.branches = branches

    def execute(self, agent):
        choice = self.decide.execute(agent)
        branch = self.branches.get(choice)
        if branch is not None:
            return branch.execute(agent)
        return None


class LoopFlow(Command):
    name = "loop"

    def __init__(self, body: Command, max_iters: int = 8,
                 until: Optional[Callable[["Agent"], bool]] = None):
        self.body = body
        self.max_iters = max_iters
        self.until = until or (lambda a: a.done)

    def execute(self, agent):
        out = None
        for _ in range(self.max_iters):
            if self.until(agent):
                break
            out = self.body.execute(agent)
        return out


class Agent:
    """Runs a flow against a task environment with an LLM backend."""

    def __init__(self, llm: Callable[[str], str], env, flow: Command,
                 logger=None):
        self.llm = llm
        self.env = env
        self.flow = flow
        self.logger = logger
        self.memory = AgentMemory(task_description=env.description())
        self.done = False
        self.last_reward = 0.0

    def run(self) -> float:
        obs = self.env.reset()
        self.memory.add("observation", obs)
        self.flow.execute(self)
        if self.logger is not None:
            self.logger.log_episode(self.memory, self.last_reward)
        return self.last_reward
