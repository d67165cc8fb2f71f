"""Agent task environments.

Parity: the reference's task adapters (Agent/src/agent/tasks/: alfworld,
babyai, gsm8k, hotpotqa, humaneval, webshop) share one contract —
reset/step/available_actions over a text interface.  Shipped here:
  * ``GSM8KStyleTask`` — arithmetic word problems with an ``answer[x]``
    action (gsm8k adapter shape),
  * ``GridWorldTask`` — a babyai/alfworld-style navigation toy,
  * ``WebShopStyleTask`` — search/click/buy over a small catalog,
  * ``HotpotQAStyleTask`` — multi-hop QA over in-memory context paragraphs
    with normalized-answer token-F1 scoring (hotpotqa adapter shape),
  * ``HumanEvalStyleTask`` — code completion scored by executing hidden
    unit tests in a restricted namespace (humaneval adapter shape),
  * ``AlfWorldStyleTask`` — household goal task (go/take/put over rooms,
    objects and receptacles; alfworld adapter shape).
All are offline and deterministic so agent flows are testable without
external datasets.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

__all__ = [
    "TextTask", "GSM8KStyleTask", "GridWorldTask", "WebShopStyleTask",
    "HotpotQAStyleTask", "HumanEvalStyleTask", "AlfWorldStyleTask",
]


class TextTask:
    def description(self) -> str:
        raise NotImplementedError

    def reset(self) -> str:
        raise NotImplementedError

    def step(self, action: str) -> Tuple[str, float, bool]:
        """→ (observation, reward, done)"""
        raise NotImplementedError

    def available_actions(self) -> List[str]:
        raise NotImplementedError


class GSM8KStyleTask(TextTask):
    def __init__(self, a: int = 17, b: int = 25):
        self.a, self.b = a, b
        self.answer = a + b

    def description(self):
        return (
            f"Alice has {self.a} apples and buys {self.b} more. "
            "How many apples does she have? Submit with answer[<number>]."
        )

    def reset(self):
        return "Solve the problem."

    def available_actions(self):
        return ["answer[<number>]"]

    def step(self, action):
        m = re.match(r"answer\[(-?\d+)\]", action.strip())
        if not m:
            return "Invalid action format.", 0.0, False
        ok = int(m.group(1)) == self.answer
        return ("Correct!" if ok else "Wrong."), (1.0 if ok else 0.0), True


class GridWorldTask(TextTask):
    """Reach the goal on a 1-D corridor: actions left/right/done."""

    def __init__(self, length: int = 5, start: int = 0, goal: int = 3):
        self.length, self.start, self.goal = length, start, goal
        self.pos = start

    def description(self):
        return (
            f"You are in a corridor of {self.length} cells at cell "
            f"{self.start}. Reach cell {self.goal} then act done[]."
        )

    def reset(self):
        self.pos = self.start
        return f"At cell {self.pos}."

    def available_actions(self):
        return ["left[]", "right[]", "done[]"]

    def step(self, action):
        a = action.strip().lower()
        if a.startswith("left"):
            self.pos = max(0, self.pos - 1)
            return f"At cell {self.pos}.", 0.0, False
        if a.startswith("right"):
            self.pos = min(self.length - 1, self.pos + 1)
            return f"At cell {self.pos}.", 0.0, False
        if a.startswith("done"):
            ok = self.pos == self.goal
            return ("Goal!" if ok else "Not at goal."), (1.0 if ok else 0.0), True
        return "Unknown action.", 0.0, False


class WebShopStyleTask(TextTask):
    CATALOG = {
        "red shirt": 12.0,
        "blue shirt": 14.0,
        "green hat": 9.0,
        "red hat": 11.0,
    }

    def __init__(self, target: str = "red hat", budget: float = 12.0):
        self.target = target
        self.budget = budget
        self.results: List[str] = []

    def description(self):
        return (
            f"Buy a '{self.target}' within budget ${self.budget:.2f}. "
            "Use search[query], click[item], buy[]."
        )

    def reset(self):
        self.results = []
        self.cart: Optional[str] = None
        return "Welcome to the shop."

    def available_actions(self):
        return ["search[<query>]", "click[<item>]", "buy[]"]

    def step(self, action):
        a = action.strip()
        m = re.match(r"search\[(.+)\]", a)
        if m:
            q = m.group(1).lower()
            self.results = [k for k in self.CATALOG if all(w in k for w in q.split())]
            return f"Results: {self.results}", 0.0, False
        m = re.match(r"click\[(.+)\]", a)
        if m:
            item = m.group(1).lower()
            if item in self.CATALOG:
                self.cart = item
                return f"{item}: ${self.CATALOG[item]:.2f}", 0.0, False
            return "No such item.", 0.0, False
        if a.startswith("buy"):
            ok = (
                self.cart == self.target
                and self.CATALOG[self.cart] <= self.budget
            )
            return ("Purchased!" if ok else "Bad purchase."), (1.0 if ok else 0.0), True
        return "Unknown action.", 0.0, False


def _normalize_answer(s: str) -> str:
    """Lowercase, strip articles/punctuation/extra whitespace (the hotpotqa
    adapter's normalize_answer contract)."""
    s = s.lower()
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    s = re.sub(r"[^a-z0-9 ]", "", s)
    return " ".join(s.split())


def _token_f1(pred: str, gold: str) -> float:
    p = _normalize_answer(pred).split()
    g = _normalize_answer(gold).split()
    if not p or not g:
        return float(p == g)
    common = 0
    gg = list(g)
    for t in p:
        if t in gg:
            gg.remove(t)
            common += 1
    if common == 0:
        return 0.0
    prec, rec = common / len(p), common / len(g)
    return 2 * prec * rec / (prec + rec)


class HotpotQAStyleTask(TextTask):
    """Multi-hop QA: the answer requires combining two context paragraphs.

    Single-step CONTINUOUS action space (the hotpotqa adapter): the agent
    answers with ``answer[...]`` and is scored by normalized token F1
    (yes/no questions are exact-match, mirroring the reference)."""

    EPISODES = [
        {
            "context": [
                "Arnholt Bridge was completed in 1931 in the city of Dalton.",
                "Dalton is the county seat of Whitfield County, Georgia.",
            ],
            "question": "In which U.S. state is the Arnholt Bridge located?",
            "answer": "Georgia",
        },
        {
            "context": [
                "The novel Windward Heights was written by Maryse Conde.",
                "Maryse Conde was born in Pointe-a-Pitre, Guadeloupe.",
            ],
            "question": "Was the author of Windward Heights born in Guadeloupe?",
            "answer": "yes",
        },
    ]

    def __init__(self, episode: int = 0, include_context: bool = True):
        self.ep = self.EPISODES[episode % len(self.EPISODES)]
        self.include_context = include_context

    def description(self):
        return "Answer the question. Respond with answer[<text>]."

    def reset(self):
        obs = ""
        if self.include_context:
            obs = "\n".join(self.ep["context"]) + "\n"
        return obs + "Question: " + self.ep["question"]

    def available_actions(self):
        return ["answer[<text>]"]

    def step(self, action):
        m = re.match(r"answer\[(.+)\]", action.strip(), re.S)
        pred = m.group(1) if m else action
        gold = self.ep["answer"]
        if _normalize_answer(gold) in ("yes", "no", "noanswer"):
            score = float(_normalize_answer(pred) == _normalize_answer(gold))
        else:
            score = _token_f1(pred, gold)
        return "", score, True


class HumanEvalStyleTask(TextTask):
    """Code completion: finish the function; hidden tests score it.

    The humaneval adapter's contract: observation is the prompt (signature
    + docstring), the action is the code body, reward 1.0 iff all hidden
    assertions pass when executed (restricted namespace, no imports)."""

    PROBLEMS = [
        {
            "prompt": (
                "def add_positive(xs):\n"
                '    """Return the sum of the strictly positive numbers in xs."""\n'
            ),
            "entry": "add_positive",
            "tests": [([1, -2, 3], 4), ([], 0), ([-1, -5], 0), ([2, 2], 4)],
        },
        {
            "prompt": (
                "def reverse_words(s):\n"
                '    """Reverse the order of words in the string s."""\n'
            ),
            "entry": "reverse_words",
            "tests": [("a b c", "c b a"), ("hello", "hello"), ("x  y", "y x")],
        },
    ]

    def __init__(self, problem: int = 0):
        self.p = self.PROBLEMS[problem % len(self.PROBLEMS)]

    def description(self):
        return "Complete the function body. Respond with the full definition."

    def reset(self):
        return self.p["prompt"]

    def available_actions(self):
        return ["<python code>"]

    def step(self, action):
        code = action
        # accept either a full def or just an indented body
        if "def " not in code:
            code = self.p["prompt"] + "\n".join(
                "    " + l for l in code.splitlines()
            )
        ns: dict = {"__builtins__": {"sum": sum, "len": len, "range": range,
                                     "abs": abs, "max": max, "min": min,
                                     "reversed": reversed, "str": str,
                                     "list": list, "int": int, "float": float}}
        try:
            exec(code, ns)  # noqa: S102 — sandboxed namespace, offline tests
            fn = ns[self.p["entry"]]
            ok = all(fn(x) == want for x, want in self.p["tests"])
        except Exception:
            ok = False
        return ("All tests passed." if ok else "Tests failed."), float(ok), True


class AlfWorldStyleTask(TextTask):
    """Household goal task: 'put the <obj> in the <receptacle>'.

    alfworld adapter shape: discrete text actions over rooms, portable
    objects and receptacles; sparse terminal reward on goal completion."""

    def __init__(self, goal_obj: str = "apple", goal_recep: str = "fridge"):
        self.rooms = {
            "kitchen": {"objects": ["apple", "mug"], "receptacles": ["fridge", "cabinet"]},
            "lounge": {"objects": ["book"], "receptacles": ["shelf"]},
        }
        self.goal_obj, self.goal_recep = goal_obj, goal_recep

    def description(self):
        return (
            f"Put the {self.goal_obj} in the {self.goal_recep}. Actions: "
            "go[<room>], take[<obj>], put[<obj> in <recep>], look[]."
        )

    def reset(self):
        self.at = "kitchen"
        self.holding: Optional[str] = None
        self.placed = {r: {k: list(v) for k, v in d.items()}
                       for r, d in self.rooms.items()}
        return f"You are in the {self.at}."

    def available_actions(self):
        return ["go[<room>]", "take[<obj>]", "put[<obj> in <recep>]", "look[]"]

    def step(self, action):
        a = action.strip()
        room = self.placed[self.at]
        m = re.match(r"go\[(.+)\]", a)
        if m:
            dest = m.group(1).strip().lower()
            if dest in self.placed:
                self.at = dest
                return f"You are in the {dest}.", 0.0, False
            return "You can't go there.", 0.0, False
        m = re.match(r"take\[(.+)\]", a)
        if m:
            obj = m.group(1).strip().lower()
            if obj in room["objects"] and self.holding is None:
                room["objects"].remove(obj)
                self.holding = obj
                return f"You take the {obj}.", 0.0, False
            return "You can't take that.", 0.0, False
        m = re.match(r"put\[(.+) in (.+)\]", a)
        if m:
            obj, recep = m.group(1).strip().lower(), m.group(2).strip().lower()
            if self.holding == obj and recep in room["receptacles"]:
                self.holding = None
                done = obj == self.goal_obj and recep == self.goal_recep
                return (
                    f"You put the {obj} in the {recep}.",
                    1.0 if done else 0.0,
                    done,
                )
            return "You can't put that there.", 0.0, False
        if a.startswith("look"):
            return (
                f"Objects: {room['objects']}; receptacles: {room['receptacles']}.",
                0.0, False,
            )
        return "Nothing happens.", 0.0, False
