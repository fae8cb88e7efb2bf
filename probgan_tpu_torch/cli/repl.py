"""Interactive REPL with the reference's command surface and prints:
``predict / score / similar / info / help / quit``, per-command arg-count
validation, KeyboardInterrupt -> clean exit, any other exception ->
print-and-continue. The port of ``probgan_tpu/cli/repl.py``.
"""

from __future__ import annotations

from probgan_tpu_torch.engine import InferenceEngine

_HELP_LINES = (
    "Available commands:",
    "predict <head_id> <relation_id> <top_k>",
    "score <head_id> <relation_id> <tail_id>",
    "similar <entity_id> <top_k>",
    "info",
    "quit",
)


def _cmd_predict(engine: InferenceEngine, argv: list[str]) -> None:
    if len(argv) != 3:
        print("Usage: predict <head_id> <relation_id> <top_k>")
        return
    head_id, rel_id, top_k = (int(a) for a in argv)
    results = engine.predict_tails([(head_id, rel_id)], top_k, return_scores=True)
    print(f"Top {top_k} predictions for ({head_id}, {rel_id}):")
    for i, (pred_id, score) in enumerate(
        zip(results["predictions"][0], results["scores"][0])
    ):
        print(f"  {i + 1:2d}. Entity {pred_id:6d} (score: {score:.4f})")


def _cmd_score(engine: InferenceEngine, argv: list[str]) -> None:
    if len(argv) != 3:
        print("Usage: score <head_id> <relation_id> <tail_id>")
        return
    head_id, rel_id, tail_id = (int(a) for a in argv)
    results = engine.score_triplets([(head_id, rel_id, tail_id)], method="both")
    print(f"Scores for triplet ({head_id}, {rel_id}, {tail_id}):")
    print(f"  Generator similarity:     {results['generator_scores'][0]:.4f}")
    print(
        f"  Discriminator probability: {results['discriminator_probabilities'][0]:.4f}"
    )
    print(f"  Discriminator logit:      {results['discriminator_logits'][0]:.4f}")


def _cmd_similar(engine: InferenceEngine, argv: list[str]) -> None:
    if len(argv) != 2:
        print("Usage: similar <entity_id> <top_k>")
        return
    entity_id, top_k = int(argv[0]), int(argv[1])
    results = engine.find_similar_entities([entity_id], top_k)
    print(f"Top {top_k} entities similar to {entity_id}:")
    similar_data = results["similar_entities"][0]
    for i, (sim_id, score) in enumerate(
        zip(similar_data["similar_entities"], similar_data["similarity_scores"])
    ):
        print(f"  {i + 1:2d}. Entity {sim_id:6d} (similarity: {score:.4f})")


def _cmd_info(engine: InferenceEngine, argv: list[str]) -> None:
    info = engine.get_model_info()
    print("Model Information:")
    print(f"  Entities: {info['model_architecture']['num_entities']:,}")
    print(f"  Relations: {info['model_architecture']['num_relations']:,}")
    print(f"  Embedding dim: {info['model_architecture']['embedding_dim']}")
    print(
        f"  Best Hit@10: {info['training_performance']['best_validation_hit10']:.4f}"
    )
    print(f"  Device: {info['device']}")


def _cmd_help(engine: InferenceEngine, argv: list[str]) -> None:
    for line in _HELP_LINES:
        print(line)


_COMMANDS = {
    "predict": _cmd_predict,
    "score": _cmd_score,
    "similar": _cmd_similar,
    "info": _cmd_info,
    "help": _cmd_help,
}


def interactive_mode(engine: InferenceEngine) -> None:
    print("\n Prot-B-GAN Interactive Mode")
    print("=" * 50)
    print("Available commands:")
    print("1. predict <head_id> <relation_id> <top_k>  - Predict tails")
    print("2. score <head_id> <relation_id> <tail_id>  - Score triplet")
    print("3. similar <entity_id> <top_k>              - Find similar entities")
    print("4. info                                     - Model information")
    print("5. help                                     - Show this help")
    print("6. quit                                     - Exit")
    print("=" * 50)

    while True:
        try:
            command = input("\n> ").strip().split()
            if not command:
                continue
            cmd = command[0].lower()
            if cmd in ("quit", "exit"):
                print("done!")
                break
            handler = _COMMANDS.get(cmd)
            if handler is None:
                print(f"Unknown command: {cmd}. Type 'help' for available commands.")
                continue
            handler(engine, command[1:])
        except (KeyboardInterrupt, EOFError):
            # EOFError: piped stdin ran out without a quit; looping on it
            # would never end
            print("\ndone! ")
            break
        except Exception as e:  # noqa: BLE001 - the REPL survives a failed command
            print(f"Error: {e}")
