"""The port's CLI surface on the CPU: parser, task dispatch, JSON output,
REPL and installer doctor, held against the JAX package's CLI."""

import json

import pytest

from probgan_tpu.cli import infer as jax_infer
from probgan_tpu_torch.cli import infer, install, repl
from probgan_tpu_torch.cli.infer import build_parser, main
from probgan_tpu_torch.engine import InferenceEngine


def _run(capsys, argv):
    main(argv)
    return capsys.readouterr().out


def _extract_json(out: str):
    """The CLI prints banners then an indented JSON blob; parse the blob."""
    return json.loads(out[out.index("{\n"):])


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.option_strings}


def test_parser_flags_and_defaults_equal_the_jax_parser():
    mine, theirs = _actions(build_parser()), _actions(jax_infer.build_parser())
    assert mine.keys() == theirs.keys()
    for dest, want in theirs.items():
        got = mine[dest]
        assert got.option_strings == want.option_strings, dest
        assert got.default == want.default, dest
        assert got.type == want.type and got.required == want.required, dest
        assert type(got) is type(want), dest
        if dest != "device":
            assert got.choices == want.choices, dest
    assert mine["device"].choices == ["auto", "cuda", "gpu", "cpu"]
    assert infer.TASKS == jax_infer.TASKS


@pytest.mark.parametrize("argv,check", [
    (["--task", "model_info"],
     lambda r: r["model_architecture"]["num_entities"] == 50 and r["device"] == "cpu:0"),
    (["--task", "predict_tails", "--input_pairs", "[[0, 1], [2, 3]]", "--top_k", "4"],
     lambda r: r["metadata"] == {"num_queries": 2, "top_k": 4,
                                 "model_hit10": pytest.approx(0.4321)}
     and len(r["scores"]) == 2 and len(r["predictions"][0]) == 4),
    (["--task", "score_triplets", "--input_triplets", "[[0, 1, 2], [3, 4, 5]]"],
     lambda r: r["metadata"]["method"] == "both" and len(r["generator_scores"]) == 2
     and len(r["discriminator_probabilities"]) == 2),
    (["--task", "similar_entities", "--input_entities", "[0, 5]", "--top_k", "3"],
     lambda r: len(r["similar_entities"]) == 2
     and r["similar_entities"][0]["query_entity"] == 0),
    (["--task", "analyze_relations", "--input_heads", "[0]", "--input_tails", "[1]",
      "--top_k", "2"],
     lambda r: len(r["relation_analysis"]) == 1
     and len(r["relation_analysis"][0]["top_relations"]) == 2),
], ids=["model_info", "predict_tails", "score_triplets", "similar_entities",
        "analyze_relations"])
@pytest.mark.parametrize("fixture", ["native_ckpt_path", "torch_ckpt_path"])
def test_task_through_main(capsys, request, fixture, argv, check):
    path = request.getfixturevalue(fixture)
    out = _run(capsys, ["--checkpoint_path", path, "--device", "cpu", *argv])
    assert "Loading Prot-B-GAN inference system..." in out
    assert "Inference ready!" in out
    assert check(_extract_json(out))


@pytest.mark.parametrize("task,message", [
    ("predict_tails", "Error: --input_pairs required for predict_tails task"),
    ("score_triplets", "Error: --input_triplets required for score_triplets task"),
    ("similar_entities", "Error: --input_entities required for similar_entities task"),
    ("analyze_relations",
     "Error: --input_heads and --input_tails required for analyze_relations task"),
])
def test_missing_input_prints_required_error(capsys, native_ckpt_path, task, message):
    out = _run(capsys, ["--checkpoint_path", native_ckpt_path, "--task", task,
                        "--device", "cpu"])
    assert message in out
    assert "{\n" not in out  # no JSON printed


def test_output_file(tmp_path, capsys, native_ckpt_path):
    out_file = tmp_path / "results.json"
    out = _run(capsys, ["--checkpoint_path", native_ckpt_path, "--task", "model_info",
                        "--output_file", str(out_file), "--device", "cpu"])
    assert f"Results saved to: {out_file}" in out
    assert json.loads(out_file.read_text())["model_architecture"]["embedding_dim"] == 16


def test_missing_checkpoint_errors():
    with pytest.raises(FileNotFoundError, match="Checkpoint not found"):
        main(["--checkpoint_path", "/does/not/exist.pt", "--task", "model_info",
              "--device", "cpu"])


def test_generate_images_is_not_ported(native_ckpt_path):
    """The task is ported now (tests/test_torch_image_checkpoint.py drives it
    on an image checkpoint, tests/test_torch_dp.py over a mesh); what still
    raises is a KG checkpoint, with the JAX CLI's error."""
    argv = ["--checkpoint_path", native_ckpt_path, "--task", "generate_images",
            "--device", "cpu"]
    with pytest.raises(ValueError) as theirs:
        jax_infer.main(argv)
    with pytest.raises(ValueError, match="Not an image-GAN checkpoint") as mine:
        main(argv)
    assert str(mine.value) == str(theirs.value)


def test_device_choices_reject_tpu(native_ckpt_path):
    with pytest.raises(SystemExit):
        main(["--checkpoint_path", native_ckpt_path, "--task", "model_info",
              "--device", "tpu"])


def test_profile_dir_writes_a_trace_or_warns(tmp_path, capsys, native_ckpt_path):
    prof_dir = tmp_path / "prof"
    out = _run(capsys, ["--checkpoint_path", native_ckpt_path, "--task", "model_info",
                        "--device", "cpu", "--profile_dir", str(prof_dir)])
    assert _extract_json(out[:out.rindex("}") + 1])["device"] == "cpu:0"
    assert list(prof_dir.glob("*.json")) or "Warning: profiler" in out


def test_seed_flag_changes_generator_noise(capsys, native_ckpt_path):
    argv = ["--checkpoint_path", native_ckpt_path, "--task", "score_triplets",
            "--input_triplets", "[[0, 1, 2]]", "--device", "cpu"]
    a = _extract_json(_run(capsys, argv))
    b = _extract_json(_run(capsys, argv))
    c = _extract_json(_run(capsys, [*argv, "--seed", "7"]))
    assert a == b
    assert a["generator_scores"] != c["generator_scores"]
    assert a["discriminator_logits"] == c["discriminator_logits"]


# -- REPL ---------------------------------------------------------------------

def _run_repl(monkeypatch, capsys, engine, commands, at_end=KeyboardInterrupt):
    it = iter(commands)

    def fake_input(prompt=""):
        try:
            return next(it)
        except StopIteration:
            raise at_end

    monkeypatch.setattr("builtins.input", fake_input)
    repl.interactive_mode(engine)
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def repl_engine(native_ckpt_path):
    return InferenceEngine(native_ckpt_path, "cpu")


def test_repl_banner_matches_the_jax_repl(monkeypatch, capsys, repl_engine):
    from probgan_tpu.cli import repl as jax_repl

    out = _run_repl(monkeypatch, capsys, repl_engine, ["quit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": "quit")
    jax_repl.interactive_mode(None)
    assert out == capsys.readouterr().out
    assert "Prot-B-GAN Interactive Mode" in out and "done!" in out


def test_repl_predict_and_info(monkeypatch, capsys, repl_engine):
    out = _run_repl(monkeypatch, capsys, repl_engine, ["predict 0 1 3", "info", "quit"])
    assert "Top 3 predictions for (0, 1):" in out
    assert "   1. Entity " in out and "(score: " in out
    assert "Model Information:" in out
    assert "Entities: 50" in out
    assert "Device: cpu:0" in out


def test_repl_score_and_similar(monkeypatch, capsys, repl_engine):
    out = _run_repl(monkeypatch, capsys, repl_engine, ["score 0 1 2", "similar 3 2", "exit"])
    assert "Scores for triplet (0, 1, 2):" in out
    assert "Generator similarity:" in out
    assert "Discriminator probability:" in out and "Discriminator logit:" in out
    assert "Top 2 entities similar to 3:" in out
    assert "(similarity: " in out


def test_repl_usage_and_unknown(monkeypatch, capsys, repl_engine):
    out = _run_repl(monkeypatch, capsys, repl_engine,
                    ["predict 1", "score 1", "similar 1", "bogus", "help", "", "quit"])
    assert "Usage: predict <head_id> <relation_id> <top_k>" in out
    assert "Usage: score <head_id> <relation_id> <tail_id>" in out
    assert "Usage: similar <entity_id> <top_k>" in out
    assert "Unknown command: bogus. Type 'help' for available commands." in out
    assert "Available commands:" in out


def test_repl_error_recovery(monkeypatch, capsys, repl_engine):
    """Per-command exceptions print and the loop carries on."""
    out = _run_repl(monkeypatch, capsys, repl_engine,
                    ["predict a b c", "predict 999 0 3", "info", "quit"])
    assert "Error: invalid literal" in out
    assert "Error: entity id 999 out of range [0, 50)" in out
    assert "Model Information:" in out


@pytest.mark.parametrize("at_end", [KeyboardInterrupt, EOFError])
def test_repl_ends_on_interrupt_and_on_end_of_input(monkeypatch, capsys, repl_engine, at_end):
    out = _run_repl(monkeypatch, capsys, repl_engine, ["info"], at_end=at_end)
    assert "Model Information:" in out
    assert out.rstrip().endswith("done!")


def test_interactive_task_runs_the_repl(monkeypatch, capsys, native_ckpt_path):
    monkeypatch.setattr("builtins.input", lambda prompt="": "quit")
    out = _run(capsys, ["--checkpoint_path", native_ckpt_path, "--device", "cpu"])
    assert "Prot-B-GAN Interactive Mode" in out and "done!" in out


# -- installer doctor -----------------------------------------------------------

def test_doctor_check_exits_0_on_the_cpu(capsys):
    assert install.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert "PyTorch - OK" in out and "NumPy - OK" in out
    assert "Version Information:" in out
    assert "torch.version.cuda:" in out and "nvcc:" in out
    assert "Accelerator count:" in out
    assert "All checks passed! Prot-B-GAN is ready to use." in out


def test_install_no_flag_prints_usage_and_exits_1(capsys):
    assert install.main([]) == 1
    out = capsys.readouterr().out
    assert "Please specify installation target:" in out
    assert "--colab" in out and "--local" in out and "--check" in out


@pytest.mark.parametrize("flag", ["--colab", "--local"])
def test_install_targets_print_and_run_nothing(monkeypatch, capsys, flag):
    """Each target runs its steps through run_command and nothing else: with
    run_command stubbed, no process starts. Its steps are the port's own
    (pip installs of torch and numpy, no jax)."""
    import subprocess

    def refuse(*args, **kwargs):
        raise AssertionError("the installer must start processes only through run_command")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    ran = []
    monkeypatch.setattr(install, "run_command", lambda cmd, desc="": (ran.append(cmd), True)[1])
    assert install.main([flag]) == 0
    out = capsys.readouterr().out
    assert ran and all(cmd.startswith("pip install ") for cmd in ran)
    assert any("torch" in cmd for cmd in ran) and not any("jax" in cmd for cmd in ran)
    assert "Installation completed successfully!" in out


def test_install_run_command_reports_success_and_failure(capsys):
    assert install.run_command("true", "probe true") is True
    assert install.run_command("false", "probe false") is False
    out = capsys.readouterr().out
    assert "Running: true" in out and "Success" in out and "Failed:" in out


@pytest.mark.parametrize("flag,fn", [("--colab", "install_colab"), ("--local", "install_local")])
def test_install_goes_on_past_a_failed_step_and_exits_1(monkeypatch, capsys, flag, fn):
    """As tests/test_install.py holds the JAX installer: every step is tried
    after one fails, the summary says so, and the exit code is 1."""
    steps = getattr(install, "_COLAB_STEPS" if fn == "install_colab" else "_LOCAL_STEPS")
    ran = []
    monkeypatch.setattr(install, "run_command",
                        lambda cmd, desc="": (ran.append(cmd), len(ran) != 1)[1])
    assert install.main([flag]) == 1
    assert ran == [cmd for cmd, _ in steps]
    assert "Some installations failed" in capsys.readouterr().out
