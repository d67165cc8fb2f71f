"""ROSLLM-style behavior execution — ROS-free capability analogue.

The reference's ROSLLM framework (ROSLLM/, paper arXiv:2406.19741) wires
an LLM to a robot stack with three pieces:

* ``agent_comm`` — a service turning prompts into LLM/VLM responses
  (agent_comm/src/agent_comm/llm.py:4-26, rosllm_srvs/srv/LLM.srv);
* ``behavior_executor`` — a node that compiles and runs an LLM-produced
  behavior against registered *atomic actions*, reporting a
  success/message/Info triple (behavior_executor/src/behavior_executor/
  node.py:13-50, info.py Info codes, rosllm_srvs/srv/ExecuteBehavior.srv
  and AtomicAction.srv);
* behavior-tree composition via the vendored BehaviorTree.CPP/smach
  externs (sequence / fallback semantics).

ROS is not available in this image (and is orthogonal to the TPU
framework), so this module reproduces the *capability*: the same
service contract (behavior string in → ``(success, message, Info)``
out), the same Info codes, the atomic-action registry with
``(input, prev_output) → (success, output)`` signature, and
sequence/fallback/retry composition — executable directly or through
the agent engine's LLM backends (agent/llm.py).

Behavior strings use a minimal s-expression tree::

    (seq (say hello) (fallback (fail x) (say recovered)) (retry 2 (flaky)))

Leaves are ``(action_name optional-input)``; composites are ``seq``,
``fallback`` and ``retry N``.  A bare ``action_name input`` line list is
also accepted (smach-style linear script).
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Info", "AtomicAction", "BehaviorExecutor", "AgentComm"]


class Info(enum.Enum):
    """Mirror of ROSLLM behavior_executor/info.py (OK=0, positive =
    warning, negative = failure)."""

    OK = 0
    NULL_BEHAVIOR = 1
    FAILED_TO_COMPILE = -1
    ATOMIC_ACTION_UNAVAILABLE = -2
    CODE_EXECUTION_ERROR = -4
    ERROR_ATOMIC_ACTION = -6


class AtomicAction:
    """Named action with the reference's AtomicAction.srv contract:
    ``(input, prev_output) → (success, output)``."""

    def __init__(self, name: str, fn: Callable[[str, str], Tuple[bool, str]]):
        self.name = name
        self.fn = fn

    def __call__(self, inp: str, prev: str) -> Tuple[bool, str]:
        return self.fn(inp, prev)


# ----------------------------------------------------------------- parsing
def _tokenize(s: str) -> List[str]:
    return s.replace("(", " ( ").replace(")", " ) ").split()


def _parse(tokens: List[str], pos: int):
    if pos >= len(tokens):
        raise ValueError("unexpected end of behavior")
    tok = tokens[pos]
    if tok == "(":
        out = []
        pos += 1
        while pos < len(tokens) and tokens[pos] != ")":
            node, pos = _parse(tokens, pos)
            out.append(node)
        if pos >= len(tokens):
            raise ValueError("unbalanced parentheses")
        return out, pos + 1
    if tok == ")":
        raise ValueError("unexpected ')'")
    return tok, pos + 1


class BehaviorExecutor:
    """Compile + run behavior strings against an atomic-action registry.

    Service contract of ExecuteBehavior.srv: ``execute_behavior(behavior)
    → (success, message, Info)``; per-action outputs chain through
    ``prev_output`` exactly like the reference's smach linear scripts.
    """

    def __init__(self) -> None:
        self._actions: Dict[str, AtomicAction] = {}
        self.trace: List[Tuple[str, bool, str]] = []

    def register(self, name: str, fn: Callable[[str, str], Tuple[bool, str]]):
        self._actions[name] = AtomicAction(name, fn)
        return self

    # ----------------------------------------------------------- compile
    def compile(self, behavior: str):
        """Parse + validate; returns the tree or raises ValueError with
        an Info-coded reason (mirrors FAILED_TO_COMPILE /
        ATOMIC_ACTION_UNAVAILABLE)."""
        behavior = (behavior or "").strip()
        if not behavior:
            return None
        if "(" not in behavior:
            # smach-style linear script: one "action [input…]" per line
            tree: list = ["seq"]
            for line in behavior.splitlines():
                parts = line.split()
                if parts:
                    tree.append(parts)
            if len(tree) == 1:
                return None
        else:
            tokens = _tokenize(behavior)
            tree, pos = _parse(tokens, 0)
            if pos != len(tokens):
                raise ValueError("trailing tokens in behavior")
        self._validate(tree)
        return tree

    def _validate(self, node) -> None:
        if isinstance(node, str):
            raise ValueError(f"bare token {node!r} outside a node")
        head = node[0] if node else None
        if head in ("seq", "sequence", "fallback"):
            for child in node[1:]:
                self._validate(child)
        elif head == "retry":
            if len(node) < 3:
                raise ValueError("retry needs a count and a child")
            int(node[1])
            for child in node[2:]:
                self._validate(child)
        else:
            if not isinstance(head, str):
                raise ValueError("action name must be a token")
            if head not in self._actions:
                raise KeyError(head)

    # ------------------------------------------------------------ execute
    def execute_behavior(self, behavior: str) -> Tuple[bool, str, Info]:
        try:
            tree = self.compile(behavior)
        except KeyError as e:
            return False, f"unknown atomic action {e.args[0]!r}", (
                Info.ATOMIC_ACTION_UNAVAILABLE
            )
        except ValueError as e:
            return False, f"behavior failed to compile: {e}", (
                Info.FAILED_TO_COMPILE
            )
        if tree is None:
            return True, "nothing happened", Info.NULL_BEHAVIOR
        self.trace = []
        try:
            ok, out = self._run(tree, "")
        except Exception as e:  # exception inside an atomic action
            return False, f"atomic action raised: {e}", Info.ERROR_ATOMIC_ACTION
        msg = "successfully executed behavior" if ok else (
            "behavior failed: " + (out or "action reported failure")
        )
        return ok, msg, Info.OK if ok else Info.CODE_EXECUTION_ERROR

    def _run(self, node, prev: str) -> Tuple[bool, str]:
        head = node[0]
        if head in ("seq", "sequence"):
            out = prev
            for child in node[1:]:
                ok, out = self._run(child, out)
                if not ok:
                    return False, out
            return True, out
        if head == "fallback":
            out = prev
            for child in node[1:]:
                ok, out = self._run(child, prev)
                if ok:
                    return True, out
            return False, out
        if head == "retry":
            n = int(node[1])
            out = prev
            for _ in range(max(1, n)):
                ok = True
                out = prev
                for child in node[2:]:
                    ok, out = self._run(child, out)
                    if not ok:
                        break
                if ok:
                    return True, out
            return False, out
        # leaf action
        inp = " ".join(t for t in node[1:] if isinstance(t, str))
        ok, out = self._actions[head](inp, prev)
        self.trace.append((head, bool(ok), out))
        return bool(ok), out


class AgentComm:
    """agent_comm analogue: LLM.srv / Observation.srv as plain calls.

    ``backend`` is any ``prompt → str`` callable (agent/llm.py MockLLM,
    HFBackend, or a real client).  ``get_behavior`` formats observations
    into the prompt and returns the model's behavior string for the
    executor — the reference's observation_manager → agent_comm →
    behavior_executor loop without the ROS bus."""

    PROMPT = (
        "You control a robot via behaviors. Available atomic actions: "
        "{actions}.\nObservations:\n{obs}\nRespond with ONLY a behavior "
        "s-expression using (seq ...), (fallback ...), (retry N ...)."
    )

    def __init__(self, backend: Callable[[str], str],
                 executor: Optional[BehaviorExecutor] = None):
        self.backend = backend
        self.executor = executor

    def llm(self, prompt: str) -> str:
        return self.backend(prompt)

    def get_behavior(self, observations: List[str]) -> str:
        actions = ", ".join(sorted(self.executor._actions)) if (
            self.executor
        ) else ""
        return self.backend(
            self.PROMPT.format(actions=actions, obs="\n".join(observations))
        )

    def step(self, observations: List[str]) -> Tuple[bool, str, Info]:
        """One observe → plan → execute cycle."""
        assert self.executor is not None, "attach a BehaviorExecutor"
        return self.executor.execute_behavior(self.get_behavior(observations))
