"""`metalchat-tpu-torch` command-line program (port of the JAX package's
``cli/main.py``, the same subcommands and flags, plus ``--device``):

  metalchat-tpu-torch -                      # read prompt from stdin
  metalchat-tpu-torch prompt -c "..."        # one-shot completion
  metalchat-tpu-torch checkout <model>       # interactive chat session
  metalchat-tpu-torch serve <model>          # JSONL (or HTTP) batch serving
  metalchat-tpu-torch model pull <url>       # clone into the store
  metalchat-tpu-torch model list
  metalchat-tpu-torch model remove <ref>
  metalchat-tpu-torch options get/set/unset/list
  metalchat-tpu-torch credential add/list/remove

``--quantize {int8,int4,w8a8,w4a8}`` quantizes the weights on load
(w8a8/w4a8: per-channel weights and dynamic int8 activations, the matvec
kernel's scheme; int8/int4: weight-only, group 32). ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs the plain PyTorch
versions of the kernels. Activations are bf16 on the card and f32 on the
CPU. The store and manifests are the JAX package's (`cli.store`).

``prompt --draft <model>`` decodes greedily with speculative decoding
(`engine.speculative`): the draft proposes ``--n-draft`` tokens a round and
the target verifies them, after a measured check of the draft/target step
ratio that ``--no-draft-check`` skips. ``serve --pp/--cp`` (pipeline and
context parallelism) run as N processes of the same command, one a rank
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set, e.g.
by ``torchrun --nproc-per-node N``): each joins the process group
(`parallel.distributed.initialize`, NCCL on the card, gloo on the CPU),
rank 0 reads the requests and broadcasts them, and rank 0 alone writes the
JSONL. ``--pp`` serves through `parallel.pipeline`'s stages, ``--cp``
prefills prompts of 512 tokens or more through `parallel.context`; both at
once (N each, on the same N ranks) prefill such prompts through the ring
over the stages' own layers. With ``--http`` rank 0 serves the HTTP API
and the other ranks follow its scheduler round by round
(`engine.http.follow`).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Optional

from metalchat_tpu_torch.cli.store import (
    CredentialStore,
    Manifest,
    ModelStore,
    home_dir,
    load_scoped_manifest,
)


def _progress(name: str, done: int, total: int) -> None:
    if total:
        pct = 100 * done // total
        bar = "#" * (pct // 4)
        sys.stderr.write(f"\r{name}: [{bar:<25}] {pct}%")
        if done >= total:
            sys.stderr.write("\n")
    else:
        sys.stderr.write(f"\r{name}: {done >> 20} MiB")
    sys.stderr.flush()


def _load_model(ref: str, args):
    """Resolve store → config (manifest options merged) → params on the
    device → tokenizer, sampler and chat templates."""
    import torch

    from metalchat_tpu_torch.chat.hf_template import load_hf_chat_templates
    from metalchat_tpu_torch.chat.interpreter import ChatTemplates
    from metalchat_tpu_torch.config import Gemma3Config, merge_options
    from metalchat_tpu_torch.device import resolve_device
    from metalchat_tpu_torch.io.loaders import load_params
    from metalchat_tpu_torch.io.repository import FilesystemRepository
    from metalchat_tpu_torch.quant.quantize import quantize_params
    from metalchat_tpu_torch.sampling import SamplerConfig

    device = resolve_device(args.device)
    store = ModelStore()
    model = store.find(ref)
    if model is None and Path(ref).is_dir():
        repo = FilesystemRepository(Path(ref))
        manifest = load_scoped_manifest()
    elif model is None:
        raise SystemExit(f"model {ref!r} not found — try `model pull`")
    else:
        repo = store.repository(ref)
        manifest = load_scoped_manifest(model.path)

    config = repo.retrieve_config()
    overrides = manifest.merged_overrides()
    if overrides:
        config = merge_options(config, overrides)
    if args.max_seq_len:
        config = config.replace(max_seq_len=args.max_seq_len)

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = load_params(repo.retrieve_weights(), config, dtype=dtype, device=device)
    if args.quantize:
        bits = {"int8": 8, "int4": 4, "w8a8": 8, "w4a8": 4}[args.quantize]
        if args.quantize.startswith("w"):
            params = quantize_params(params, bits=bits, group_size=None, act_bits=8)
        else:
            params = quantize_params(params, bits=bits, group_size=32)

    tokenizer = repo.retrieve_tokenizer()
    sampling = manifest.inference.get("sampling", {})
    sampler = SamplerConfig(
        temperature=float(sampling.get("temperature", 0.6)),
        top_k=int(sampling.get("k", 50)),
        top_p=float(sampling.get("probability", 0.9)),
    )
    # The checkpoint's own chat template (tokenizer_config.json) first, then
    # the built-in mustache formats.
    model_dir = model.path if model is not None else Path(ref)
    try:
        templates = load_hf_chat_templates(model_dir)
    except (OSError, ValueError):
        templates = None
    if templates is None:
        templates = (ChatTemplates.gemma3() if isinstance(config, Gemma3Config)
                     else ChatTemplates.llama3())
    return params, config, tokenizer, sampler, templates


def _load_session(ref: str, args):
    """The model behind a chat `Interpreter`."""
    from metalchat_tpu_torch.chat.interpreter import Interpreter

    params, config, tokenizer, sampler, templates = _load_model(ref, args)
    return Interpreter(params, config, tokenizer, templates=templates, sampler=sampler,
                       max_reply_tokens=args.max_tokens)


def _cmd_prompt(args) -> int:
    content = args.content
    if content is None:
        content = sys.stdin.read()
    session = _load_session(args.model, args)
    if args.system:
        session.write(args.system, role="system")
    session.write(content, role="user")
    if getattr(args, "draft", None):
        return _prompt_speculative(args, session)
    for chunk in session.read_stream():
        sys.stdout.write(chunk)
        sys.stdout.flush()
    sys.stdout.write("\n")
    return 0


def _prompt_speculative(args, session) -> int:
    """One-shot completion through draft/target speculative decoding: the
    session renders the prompt (its templates and tokenizer), the draft
    model proposes and the target verifies, so the reply is exactly the
    target's greedy decode (`engine.speculative`)."""
    import torch

    from metalchat_tpu_torch.engine.speculative import speculative_generate

    draft = _load_session(args.draft, args)
    if getattr(args, "draft_check", True):
        _warn_futile_speculation(args, session, draft)
    session.write_header(session.assistant_role)
    prompt_tokens = torch.tensor([session._buffer], dtype=torch.int64)
    tokens, stats = speculative_generate(
        session.params, session.config, draft.params, draft.config, prompt_tokens,
        max_new_tokens=args.max_tokens, n_draft=args.n_draft, temperature=0.0,
        eos_ids=tuple(session.stop_ids))
    out = [int(t) for t in tokens if int(t) not in session.stop_ids]
    sys.stdout.write(session.tokenizer.decode(out))
    sys.stdout.write("\n")
    sys.stderr.write(
        f"[speculative] accept_rate={stats['accept_rate']:.2f} "
        f"tokens/iteration={stats['tokens_per_iteration']:.2f}\n")
    return 0


def _warn_futile_speculation(args, session, draft) -> None:
    """Measure t_draft / t_target (`measure_step_ratio`) and the verify
    window's cost in target steps (`measure_verify_ratio`) on the running
    device, and warn when the breakeven accept rate they imply is above
    0.85, where speculation is likely to slow decode down. A failed
    measurement raises: on the card it would be a kernel's fault.
    ``--no-draft-check`` skips it."""
    from metalchat_tpu_torch.engine.speculative import (
        breakeven_accept_rate,
        measure_step_ratio,
        measure_verify_ratio,
    )

    ratio = measure_step_ratio(session.params, session.config, draft.params, draft.config)
    verify = measure_verify_ratio(session.params, session.config, n_draft=args.n_draft)
    alpha = breakeven_accept_rate(ratio, n_draft=args.n_draft, verify_rel=verify)
    if alpha is None or alpha > 0.85:
        need = "unattainable" if alpha is None else f"{alpha:.2f}"
        sys.stderr.write(
            f"[speculative] WARNING: draft step costs {ratio:.2f}x the target step and "
            f"the verify {verify:.2f} target steps — "
            f"breakeven accept rate {need} (> 0.85); this configuration is likely "
            f"to SLOW decode down. Use a much smaller draft or drop --draft.\n")
    else:
        sys.stderr.write(f"[speculative] step ratio {ratio:.2f}, verify {verify:.2f} target "
                         f"steps, breakeven accept rate {alpha:.2f}\n")


def _cmd_checkout(args) -> int:
    session = _load_session(args.model, args)
    if args.system:
        session.write(args.system, role="system")
    print("(interactive session — empty line or Ctrl-D to exit)")
    while True:
        try:
            line = input(">>> ")
        except EOFError:
            break
        if not line.strip():
            break
        reply = session.exec(line)
        print(reply)
    return 0


def _join_ranks(args, n: int) -> bool:
    """Join the process group of a ``serve --pp/--cp N`` launch (one process
    a rank, ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
    set, e.g. by ``torchrun``), whose size must be N; on the card, make the
    rank's own card (``LOCAL_RANK``, else the rank) the current one. The
    backend is `parallel.distributed.initialize`'s for ``--device``. Returns
    whether this call started the group (and so ends it)."""
    import torch
    import torch.distributed as dist

    from metalchat_tpu_torch.parallel.distributed import initialize

    started = not dist.is_initialized()
    initialize(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise SystemExit(f"serve --pp/--cp {n}: {world} processes; start {n} processes of "
                         "this command (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT set, "
                         "e.g. by torchrun)")
    if torch.device(args.device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return started


def _cmd_serve(args) -> int:
    """Batch-serve prompts: JSONL in → JSONL out through the
    continuous-batching engine (one line: {"prompt": "...", "max_tokens": N,
    "temperature": T, "top_k": K, "top_p": P}), or an HTTP API. With
    ``--pp N`` and/or ``--cp N`` every one of N processes runs this command
    in lockstep: rank 0 reads the requests and broadcasts them (or serves
    HTTP and broadcasts what its handlers queue), every rank serves them,
    rank 0 alone writes the JSONL."""
    ranks = max(args.pp, args.cp)
    if args.pp > 1 and args.cp > 1 and args.pp != args.cp:
        raise SystemExit(
            f"serve --pp {args.pp} --cp {args.cp}: the context-parallel prefill runs over "
            "the pipeline's own ranks, so give --cp equal to --pp (the JAX CLI fails on the "
            "first prompt of 512 tokens or more: its cp mesh holds other devices than the "
            "pipeline's)")
    started = _join_ranks(args, ranks) if ranks > 1 else False
    try:
        return _serve(args)
    finally:
        if started:
            from metalchat_tpu_torch.parallel.distributed import shutdown

            shutdown()


def build_serve_engine(params, config, *, pp: int = 0, cp: int = 0, slots: int = 8,
                       max_seq_len: Optional[int] = None, paged: bool = False,
                       quantized_kv: bool = False, burst: int = 1):
    """``serve``'s engine on the whole tree ``params``: with ``pp`` > 1 this
    rank's pipeline stage (`parallel.pipeline`: its layers, the pipeline
    forward and the stage's dense cache), with ``cp`` > 1 a context-parallel
    mesh over the same ranks (prompts of 512 tokens or more through the ring
    prefill, over the stages' own layers under pp). Returns (the engine, the
    grid whose rank 0 reads the requests, or None in one process)."""
    from metalchat_tpu_torch.engine.serving import ContinuousBatchingEngine

    max_seq = max_seq_len or config.max_seq_len
    mesh = forward_fn = ext_cache = cp_mesh = None
    if pp > 1:
        # Pipeline-parallel serving: this rank's layer stage.
        from metalchat_tpu_torch.cache import KVCache, QuantizedKVCache
        from metalchat_tpu_torch.parallel import (
            make_pipeline_forward,
            make_pp_mesh,
            shard_cache_pp,
            shard_params_pp,
        )

        mesh = make_pp_mesh(pp=pp)
        params = shard_params_pp(params, mesh)
        forward_fn = make_pipeline_forward(config, mesh, n_microbatches=1)
        device = params["final_norm"].device
        whole = (QuantizedKVCache.create(config, slots, max_seq, device=device)
                 if quantized_kv else
                 KVCache.create(config, slots, max_seq, dtype=params["final_norm"].dtype,
                                device=device))
        ext_cache = shard_cache_pp(whole, mesh)
    if cp > 1:
        # Context-parallel prefill: long prompts through ring attention.
        from metalchat_tpu_torch.parallel import make_grid_mesh

        cp_mesh = make_grid_mesh({"sp": cp})
        if mesh is None:
            mesh = cp_mesh
    engine = ContinuousBatchingEngine(
        params, config,
        max_slots=slots, max_seq_len=max_seq,
        cache_mode="paged" if paged else "dense",
        quantized_kv=quantized_kv,
        decode_burst=burst,
        forward_fn=forward_fn, cache=ext_cache,
        context_parallel_mesh=cp_mesh,
    )
    return engine, mesh


def _serve(args) -> int:
    import json as _json

    from metalchat_tpu_torch.engine.serving import Request
    from metalchat_tpu_torch.sampling import SamplerConfig
    from metalchat_tpu_torch.text.tokenizer import TokenKind

    params, config, tokenizer, _, _ = _load_model(args.model, args)
    specials = getattr(tokenizer, "specials", None)
    stop_kinds = TokenKind.END_TEXT | TokenKind.END_TURN | TokenKind.END_MESSAGE
    eos_ids = tuple(specials.ids_with_kind(stop_kinds)) if specials else ()

    engine, mesh = build_serve_engine(
        params, config, pp=args.pp, cp=args.cp, slots=args.slots,
        max_seq_len=args.max_seq_len, paged=args.paged, quantized_kv=args.quantized_kv,
        burst=args.burst)
    del params
    if args.http is not None:
        import time as _time

        from metalchat_tpu_torch.engine.http import InferenceServer, follow

        if mesh is not None and mesh.rank != 0:
            # Rank 0 serves HTTP; this rank steps its engine in lockstep.
            follow(engine, mesh)
            return 0
        server = InferenceServer(engine, tokenizer, model_name=args.model,
                                 default_max_tokens=args.max_tokens,
                                 eos_ids=eos_ids, mesh=mesh)
        port = server.start(host=args.host, port=args.http)
        print(f"listening on http://{args.host}:{port}", file=sys.stderr)
        try:
            while True:
                _time.sleep(3600)
        except KeyboardInterrupt:
            server.stop()
        return 0
    root = mesh is None or mesh.rank == 0
    requests, texts = [], []
    source = (open(args.input) if args.input else sys.stdin) if root else ()
    for line in source:
        line = line.strip()
        if not line:
            continue
        spec = _json.loads(line)
        requests.append(Request(
            prompt=tokenizer.encode(spec["prompt"], allow_special=True),
            max_new_tokens=int(spec.get("max_tokens", args.max_tokens)),
            sampler=SamplerConfig(
                temperature=float(spec.get("temperature", 0.0)),
                top_k=int(spec.get("top_k", 0)),
                top_p=float(spec.get("top_p", 1.0)),
            ),
            eos_ids=eos_ids,
        ))
        texts.append(spec["prompt"])
    if mesh is not None:
        from metalchat_tpu_torch.parallel.multihost import broadcast_requests

        requests = broadcast_requests(mesh, requests if root else None)
    out = engine.run(requests)
    if not root:
        return 0
    for req, text in zip(requests, texts):
        completion = out[req.request_id]
        sys.stdout.write(_json.dumps({
            "prompt": text,
            "text": tokenizer.decode(completion.tokens),
            "tokens": len(completion.tokens),
            "finish_reason": completion.finish_reason,
            "ttft_s": completion.ttft,
        }) + "\n")
    summary = engine.metrics()
    print(f"served {len(requests)} requests: {summary}", file=sys.stderr)
    return 0


def _cmd_model(args) -> int:
    store = ModelStore()
    if args.action == "pull":
        token = args.token or CredentialStore().get("huggingface.co")
        model = store.pull(args.url, name=args.name, token=token, progress=_progress)
        print(f"pulled {model.name} → {model.id}")
    elif args.action == "list":
        for m in store.list():
            print(f"{m.id[:12]}  {m.name}  {m.manifest.model.get('url', '')}")
    elif args.action == "remove":
        ok = store.remove(args.ref)
        if not ok:
            print(f"model {args.ref!r} not found", file=sys.stderr)
            return 1
        print(f"removed {args.ref}")
    return 0


def _manifest_path(scope: str, model_ref: Optional[str]) -> Path:
    if scope == "local":
        return Path.cwd() / Manifest.FILENAME
    if scope == "global":
        return home_dir() / Manifest.FILENAME
    store = ModelStore()
    model = store.find(model_ref or "")
    if model is None:
        raise SystemExit(f"model {model_ref!r} not found")
    return model.path / Manifest.FILENAME


def _cmd_options(args) -> int:
    path = _manifest_path(args.scope, getattr(args, "model", None))
    manifest = Manifest.load(path) if path.exists() else Manifest()
    if args.action == "list":
        for k, v in sorted(manifest.options.items()):
            print(f"{k} = {v}")
        for k, v in sorted(manifest.inference.items()):
            print(f"inference.{k} = {v}")
    elif args.action == "get":
        section, key = _split_option(args.key)
        table = manifest.inference if section == "inference" else manifest.options
        if key not in table:
            return 1
        print(table[key])
    elif args.action == "set":
        section, key = _split_option(args.key)
        value: object = args.value
        try:
            value = int(args.value)
        except ValueError:
            try:
                value = float(args.value)
            except ValueError:
                pass
        (manifest.inference if section == "inference" else manifest.options)[key] = value
        manifest.save(path)
    elif args.action == "unset":
        section, key = _split_option(args.key)
        (manifest.inference if section == "inference" else manifest.options).pop(key, None)
        manifest.save(path)
    return 0


def _split_option(key: str):
    if key.startswith("inference."):
        return "inference", key.split(".", 1)[1]
    return "options", key


def _cmd_credential(args) -> int:
    creds = CredentialStore()
    if args.action == "add":
        creds.add(args.host, args.token)
    elif args.action == "list":
        for host in creds.list_hosts():
            print(host)
    elif args.action == "remove":
        creds.remove(args.host)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="metalchat-tpu-torch")
    sub = parser.add_subparsers(dest="command")

    def add_infer_args(p):
        p.add_argument("model", nargs="?", default="default")
        p.add_argument("--system", default=None)
        p.add_argument("--max-tokens", type=int, default=512)
        p.add_argument("--max-seq-len", type=int, default=None)
        p.add_argument("--quantize", choices=["int8", "int4", "w8a8", "w4a8"], default=None)
        p.add_argument("--device", default="cuda",
                       help="torch device (default: the card; 'cpu' runs the plain "
                            "PyTorch versions of the kernels)")

    prompt = sub.add_parser("prompt", help="one-shot completion")
    add_infer_args(prompt)
    prompt.add_argument("-c", "--content", default=None)
    prompt.add_argument("--draft", default=None, metavar="MODEL",
                        help="speculative decoding: draft model ref")
    prompt.add_argument("--n-draft", type=int, default=4,
                        help="draft tokens proposed per verify round")
    prompt.add_argument("--no-draft-check", dest="draft_check",
                        action="store_false", default=True,
                        help="skip the measured draft/target step-ratio check")
    prompt.set_defaults(fn=_cmd_prompt)

    stdin_p = sub.add_parser("-", help="prompt from stdin")
    add_infer_args(stdin_p)
    stdin_p.set_defaults(fn=_cmd_prompt, content=None)

    checkout = sub.add_parser("checkout", help="interactive chat")
    add_infer_args(checkout)
    checkout.set_defaults(fn=_cmd_checkout)

    serve = sub.add_parser("serve", help="batch-serve JSONL prompts")
    add_infer_args(serve)
    serve.add_argument("--input", default=None, help="JSONL file (default stdin)")
    serve.add_argument("--http", type=int, default=None, metavar="PORT",
                       help="serve an OpenAI-compatible HTTP API instead of JSONL")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--slots", type=int, default=8)
    serve.add_argument("--burst", type=int, default=32,
                       help="decode burst: tokens per dispatched decode program")
    serve.add_argument("--paged", action="store_true")
    serve.add_argument("--quantized-kv", action="store_true")
    serve.add_argument("--pp", type=int, default=0, metavar="N",
                       help="pipeline-parallel serving over N processes, one a rank "
                            "(layer stages on a pp mesh)")
    serve.add_argument("--cp", type=int, default=0, metavar="N",
                       help="context-parallel prefill over N processes, one a rank "
                            "(long prompts through ring attention)")
    serve.set_defaults(fn=_cmd_serve)

    model = sub.add_parser("model", help="manage models")
    msub = model.add_subparsers(dest="action", required=True)
    pull = msub.add_parser("pull")
    pull.add_argument("url")
    pull.add_argument("--name", default=None)
    pull.add_argument("--token", default=None)
    msub.add_parser("list")
    remove = msub.add_parser("remove")
    remove.add_argument("ref")
    model.set_defaults(fn=_cmd_model)

    options = sub.add_parser("options", help="manifest options")
    osub = options.add_subparsers(dest="action", required=True)
    for action in ("get", "set", "unset", "list"):
        p = osub.add_parser(action)
        p.add_argument("--scope", choices=["local", "global", "model"], default="local")
        p.add_argument("--model", default=None)
        if action in ("get", "set", "unset"):
            p.add_argument("key")
        if action == "set":
            p.add_argument("value")
    options.set_defaults(fn=_cmd_options)

    credential = sub.add_parser("credential", help="auth tokens")
    csub = credential.add_subparsers(dest="action", required=True)
    add = csub.add_parser("add")
    add.add_argument("host")
    add.add_argument("token")
    csub.add_parser("list")
    rm = csub.add_parser("remove")
    rm.add_argument("host")
    credential.set_defaults(fn=_cmd_credential)
    return parser


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "command", None):
        parser.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
