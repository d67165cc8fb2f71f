"""The agent engine in hebo_tpu_torch (``agent/*``, host code copied from
hebo_tpu) against hebo_tpu, and the import of the EM-LLM and agent slice.

Every case of tests/test_agent.py and tests/test_behavior.py runs on both
packages through the same scripted ``MockLLM``: the port gives the JAX
package's prompts (``MockLLM.calls``), rewards, step kinds and contents
(their wall-clock stamps aside), behavior traces and Info codes, and the
cases' own assertions hold on the port.  A subprocess imports
``hebo_tpu_torch.emllm`` (with its HF runner) and ``hebo_tpu_torch.agent``
with jax, flax, optax and hebo_tpu blocked and checks that transformers
was not loaded; the entry points raise without CUDA unless given
``device="cpu"``.
"""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _package(root):
    import importlib

    return SimpleNamespace(**{m: importlib.import_module(f"{root}.agent.{m}")
                              for m in ("core", "llm", "logger", "parsers", "tasks", "behavior")})


@pytest.fixture(scope="module")
def both():
    return {"jax": _package("hebo_tpu"), "port": _package("hebo_tpu_torch")}


def _record(agent, llm, reward):
    return {"calls": list(llm.calls), "reward": reward,
            "steps": [(s["kind"], s["content"]) for s in agent.memory.steps]}


# ------------------------------------------------------ tests/test_agent.py
def case_parse_action(A, tmp):
    p = A.parsers
    assert p.parse_action("I will go right.\nAction: right[]") == "right[]"
    assert p.parse_action("answer[42] is my move") == "answer[42]"
    assert p.parse_action("no action here") == ""
    assert p.parse_final_answer("Final answer: 42") == "42"
    return [p.parse_action(t) for t in ("Action : search[red hat] then", "x[] y[]", "go [3]")] + \
        [p.parse_final_answer(t) for t in ("answer = 7", "nothing")]


def case_gsm8k_flow_success(A, tmp):
    c = A.core
    llm = A.llm.MockLLM(script=["17 + 25 = 42, so the answer is 42.", "Action: answer[42]"])
    agent = c.Agent(llm, A.tasks.GSM8KStyleTask(17, 25), c.SequentialFlow([c.ThinkCommand(), c.ActCommand()]))
    reward = agent.run()
    assert reward == 1.0
    kinds = [s["kind"] for s in agent.memory.steps]
    assert "thought" in kinds and "action" in kinds
    return _record(agent, llm, reward)


def case_gridworld_loop_flow(A, tmp):
    c = A.core
    llm = A.llm.MockLLM(script=["Action: right[]"] * 3 + ["Action: done[]"])
    agent = c.Agent(llm, A.tasks.GridWorldTask(length=5, start=0, goal=3), c.LoopFlow(c.ActCommand(), max_iters=8))
    reward = agent.run()
    assert reward == 1.0
    return _record(agent, llm, reward)


def case_decision_flow_branches(A, tmp):
    c = A.core
    llm = A.llm.MockLLM(rules={"Options: shop, solve": "shop", "Available actions": "Action: search[red hat]"})
    decide = c.DecideCommand("What kind of task is this?", ["shop", "solve"])
    agent = c.Agent(llm, A.tasks.WebShopStyleTask(),
                    c.DecisionFlow(decide, {"shop": c.ActCommand(), "solve": c.ThinkCommand()}))
    reward = agent.run()
    decisions = [s for s in agent.memory.steps if s["kind"] == "decision"]
    assert decisions and decisions[0]["content"] == "shop"
    assert any("red hat" in s["content"] for s in agent.memory.steps if s["kind"] == "observation")
    return _record(agent, llm, reward)


def case_webshop_full_episode(A, tmp):
    c = A.core
    llm = A.llm.MockLLM(script=["Action: search[red hat]", "Action: click[red hat]", "Action: buy[]"])
    agent = c.Agent(llm, A.tasks.WebShopStyleTask(target="red hat", budget=12.0),
                    c.LoopFlow(c.ActCommand(), max_iters=6))
    reward = agent.run()
    assert reward == 1.0
    return _record(agent, llm, reward)


def case_episode_logger(A, tmp):
    c = A.core
    p = tmp / f"{A.core.__name__}.jsonl"
    llm = A.llm.MockLLM(script=["Action: answer[42]"])
    agent = c.Agent(llm, A.tasks.GSM8KStyleTask(17, 25), c.LoopFlow(c.ActCommand(), 2),
                    logger=A.logger.EpisodeLogger(str(p)))
    reward = agent.run()
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["reward"] == 1.0
    return dict(_record(agent, llm, reward), logged={k: rec[k] for k in ("task", "reward")},
                logged_steps=[(s["kind"], s["content"]) for s in rec["steps"]])


def case_hotpotqa_style_task(A, tmp):
    t = A.tasks.HotpotQAStyleTask(0)
    obs = t.reset()
    assert "Question:" in obs
    _, r, done = t.step("answer[Georgia]")
    assert r == 1.0 and done
    _, r_partial, _ = t.step("answer[the state of Georgia]")
    assert 0.0 < r_partial <= 1.0
    t2 = A.tasks.HotpotQAStyleTask(1)
    obs2 = t2.reset()
    _, r_yes, _ = t2.step("answer[yes]")
    _, r_no, _ = t2.step("answer[certainly yes]")
    assert r_yes == 1.0 and r_no == 0.0
    return [obs, r, r_partial, obs2, r_yes, r_no]


def case_humaneval_style_task(A, tmp):
    t = A.tasks.HumanEvalStyleTask(0)
    prompt = t.reset()
    assert prompt.startswith("def add_positive")
    out = [t.step("def add_positive(xs):\n    return sum(x for x in xs if x > 0)"),
           t.step("def add_positive(xs):\n    return len(xs)"),
           t.step("return sum(x for x in xs if x > 0)"),
           t.step("def add_positive(xs:\n   oops")]
    assert [o[1] for o in out] == [1.0, 0.0, 1.0, 0.0] and out[0][2]
    return [prompt] + out


def case_alfworld_style_task(A, tmp):
    t = A.tasks.AlfWorldStyleTask(goal_obj="apple", goal_recep="fridge")
    out = [t.reset(), t.step("take[apple]"), t.step("put[apple in fridge]")]
    assert out[1][1:] == (0.0, False) and out[2][1:] == (1.0, True)
    out += [t.reset(), t.step("take[mug]"), t.step("put[mug in cabinet]")]
    assert out[-1][1:] == (0.0, False)
    out += [t.reset(), t.step("go[lounge]")]
    assert "lounge" in out[-1][0]
    return out


def case_agent_flow_on_new_tasks(A, tmp):
    c = A.core
    llm = A.llm.MockLLM(script=["take[apple]", "put[apple in fridge]"])
    agent = c.Agent(llm, A.tasks.AlfWorldStyleTask(), c.LoopFlow(c.ActCommand(), max_iters=4))
    reward = agent.run()
    assert reward == 1.0
    return _record(agent, llm, reward)


# --------------------------------------------------- tests/test_behavior.py
def _make_exec(A):
    ex = A.behavior.BehaviorExecutor()
    ex.register("say", lambda inp, prev: (True, inp))
    ex.register("append", lambda inp, prev: (True, prev + "+" + inp))
    ex.register("fail", lambda inp, prev: (False, "nope"))
    state = {"n": 0}

    def flaky(inp, prev):
        state["n"] += 1
        return state["n"] >= 2, f"try{state['n']}"

    ex.register("flaky", flaky)
    ex.register("boom", lambda inp, prev: 1 / 0)
    return ex


def _run(A, ex, behavior):
    ok, msg, info = ex.execute_behavior(behavior)
    return ok, msg, info.name, list(ex.trace)


def case_sequence_chains_outputs(A, tmp):
    ex = _make_exec(A)
    out = _run(A, ex, "(seq (say a) (append b) (append c))")
    assert out[0] and out[2] == "OK" and ex.trace[-1][2] == "a+b+c"
    return out


def case_fallback_recovers(A, tmp):
    ex = _make_exec(A)
    out = _run(A, ex, "(fallback (fail x) (say recovered))")
    assert out[0] and out[2] == "OK" and ex.trace[-1] == ("say", True, "recovered")
    return out


def case_retry_until_success(A, tmp):
    ex = _make_exec(A)
    out = _run(A, ex, "(retry 3 (flaky))")
    assert out[0] and out[2] == "OK"
    return out


def case_failure_and_info_codes(A, tmp):
    ex = _make_exec(A)
    out = [_run(A, ex, b) for b in ("(seq (fail x))", "(seq (unknown_action))", "(seq (say a", "", "(seq (boom))")]
    assert [(o[0], o[2]) for o in out] == [
        (False, "CODE_EXECUTION_ERROR"), (False, "ATOMIC_ACTION_UNAVAILABLE"), (False, "FAILED_TO_COMPILE"),
        (True, "NULL_BEHAVIOR"), (False, "ERROR_ATOMIC_ACTION")]
    return out


def case_linear_script_form(A, tmp):
    ex = _make_exec(A)
    out = _run(A, ex, "say a\nappend b")
    assert out[0] and out[2] == "OK" and ex.trace[-1][2] == "a+b"
    return out


def case_agent_comm_loop(A, tmp):
    ex = _make_exec(A)
    prompts = []

    def backend(prompt):
        assert "say" in prompt and "Observations" in prompt
        prompts.append(prompt)
        return "(seq (say hello) (append world))"

    ok, msg, info = A.behavior.AgentComm(backend, ex).step(["robot is idle"])
    assert ok and info.name == "OK" and ex.trace[-1][2] == "hello+world"
    return prompts, ok, msg, info.name, list(ex.trace)


CASES = {n[len("case_"):]: f for n, f in dict(globals()).items() if n.startswith("case_")}


@pytest.mark.parametrize("case", list(CASES))
def test_agent_case_as_reference(both, case, tmp_path):
    got = CASES[case](both["port"], tmp_path)
    want = CASES[case](both["jax"], tmp_path)
    assert got == want


# ------------------------------------------------------- import and device
def test_emllm_and_agent_import_with_jax_blocked():
    code = """
import sys
for name in ("jax", "flax", "optax", "hebo_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import hebo_tpu_torch.emllm, hebo_tpu_torch.agent, hebo_tpu_torch.emllm.hf_integration
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "hebo_tpu", "transformers")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_emllm_and_agent_export_the_references_names(both):
    import hebo_tpu.agent as jagent
    import hebo_tpu.emllm as jemllm
    import hebo_tpu_torch.agent as pagent
    import hebo_tpu_torch.emllm as pemllm

    for j, p in ((jemllm, pemllm), (jagent, pagent)):
        names = {n for n in dir(j) if not n.startswith("_")}
        assert names <= set(dir(p)), names - set(dir(p))
    assert [i.name for i in both["port"].behavior.Info] == [i.name for i in both["jax"].behavior.Info]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hebo_tpu_torch.agent.llm import HFBackend
    from hebo_tpu_torch.emllm import EMLLMAttention, EpisodicKVMemory
    from hebo_tpu_torch.emllm.hf_integration import EMLLMRunner

    for make in (lambda: EpisodicKVMemory(), lambda: EMLLMAttention(2, 8), lambda: HFBackend(),
                 lambda: EMLLMRunner(torch.nn.Linear(1, 1))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert HFBackend(device="cpu")._pipe is None  # the pipeline is built at the first prompt
