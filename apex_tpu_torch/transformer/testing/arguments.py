"""Megatron-style argument parser (counterpart of
``apex_tpu/transformer/testing/arguments.py``, the same flag groups and
checks).

The reference's flag groups (network size, logging, regularization,
training, initialization, learning rate, checkpointing, mixed precision,
distributed, validation, data, autoresume, biencoder, vision,
inference) with ``validate_args``' consistency checks; knobs that only
configure the reference's CUDA internals (``--DDP-impl``, fusion and
allocator toggles) are accepted and ignored, so reference command lines
keep working. The world size defaults to the ``torch.distributed``
world (1 without a process group), where the JAX one counts devices.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch.distributed as dist


def _default_world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def parse_args(
    extra_args_provider=None,
    defaults: Optional[dict] = None,
    ignore_unknown_args: bool = True,
    args: Optional[List[str]] = None,
):
    """Reference ``arguments.py:parse_args`` — returns a validated namespace."""
    parser = argparse.ArgumentParser(
        description="apex_tpu_torch Megatron-style arguments", allow_abbrev=False
    )
    _add_network_size_args(parser)
    _add_logging_args(parser)
    _add_regularization_args(parser)
    _add_training_args(parser)
    _add_initialization_args(parser)
    _add_learning_rate_args(parser)
    _add_checkpointing_args(parser)
    _add_mixed_precision_args(parser)
    _add_distributed_args(parser)
    _add_validation_args(parser)
    _add_data_args(parser)
    _add_autoresume_args(parser)
    _add_biencoder_args(parser)
    _add_vision_args(parser)
    _add_inference_args(parser)
    if extra_args_provider is not None:
        parser = extra_args_provider(parser)

    if ignore_unknown_args:
        namespace, _ = parser.parse_known_args(args)
    else:
        namespace = parser.parse_args(args)

    if defaults:
        for k, v in defaults.items():
            if getattr(namespace, k, None) is None:
                setattr(namespace, k, v)

    return validate_args(namespace)


def validate_args(args):
    """Consistency checks mirroring reference ``arguments.py`` validation."""
    # Deprecated arguments (reference :105-131): hard errors for the
    # removed spellings, silent upgrades for the recompute shorthands.
    if args.batch_size is not None:
        raise ValueError(
            "--batch-size argument is no longer valid, use "
            "--micro-batch-size instead")
    del args.batch_size
    if args.warmup is not None:
        raise ValueError(
            "--warmup argument is no longer valid, use "
            "--lr-warmup-fraction instead")
    del args.warmup
    if args.model_parallel_size is not None:
        raise ValueError(
            "--model-parallel-size is no longer valid, use "
            "--tensor-model-parallel-size instead")
    del args.model_parallel_size
    if args.checkpoint_activations:
        args.recompute_granularity = "full"
        args.recompute_method = "uniform"
    del args.checkpoint_activations
    if args.recompute_activations:
        args.recompute_granularity = "selective"
    del args.recompute_activations
    if args.local_rank_underscore is not None:
        # torch.distributed.launch passes --local_rank; fold into the
        # canonical spelling
        args.local_rank = args.local_rank_underscore
    del args.local_rank_underscore

    world = args.world_size or _default_world_size()
    args.world_size = world
    model_parallel = (
        args.tensor_model_parallel_size * args.pipeline_model_parallel_size
    )
    if world % model_parallel != 0:
        raise ValueError(
            f"world size ({world}) is not divisible by tensor "
            f"({args.tensor_model_parallel_size}) x pipeline "
            f"({args.pipeline_model_parallel_size}) parallel sizes"
        )
    args.data_parallel_size = world // model_parallel

    if args.fp16 and args.bf16:
        raise ValueError("cannot specify both fp16 and bf16")
    args.params_dtype = "float32"
    if args.fp16:
        args.params_dtype = "float16"
    if args.bf16:
        args.params_dtype = "bfloat16"
    if args.accumulate_allreduce_grads_in_fp32 is None:
        # reference default: fp32 grad accumulation whenever 16-bit params
        args.accumulate_allreduce_grads_in_fp32 = bool(args.fp16 or args.bf16)

    if args.ffn_hidden_size is None:
        args.ffn_hidden_size = 4 * args.hidden_size
    if args.kv_channels is None:
        if args.hidden_size % args.num_attention_heads != 0:
            raise ValueError("hidden size must be divisible by attention heads")
        args.kv_channels = args.hidden_size // args.num_attention_heads

    if args.seq_length is not None and args.max_position_embeddings is not None:
        if args.max_position_embeddings < args.seq_length:
            raise ValueError(
                "max_position_embeddings must be at least seq_length"
            )
    # batch-size consistency (reference: micro * dp divides global)
    if args.micro_batch_size is not None and args.global_batch_size is not None:
        micro_times_dp = args.micro_batch_size * args.data_parallel_size
        if args.global_batch_size % micro_times_dp != 0:
            raise ValueError(
                f"global batch size ({args.global_batch_size}) is not "
                f"divisible by micro batch size ({args.micro_batch_size}) "
                f"times data parallel size ({args.data_parallel_size})"
            )
    if args.rampup_batch_size is not None and len(args.rampup_batch_size) != 3:
        raise ValueError(
            "--rampup-batch-size takes exactly 3 values: "
            "<start> <increment> <sample count>"
        )
    if args.sequence_parallel and args.tensor_model_parallel_size == 1:
        # SP without TP is a no-op; the reference asserts similarly
        args.sequence_parallel = False
    if args.num_layers_per_virtual_pipeline_stage is not None:
        if args.pipeline_model_parallel_size <= 2:
            raise ValueError(
                "pipeline-model-parallel size should be greater than 2 "
                "with interleaved schedule")
        if args.num_layers is None:
            raise ValueError(
                "--num-layers-per-virtual-pipeline-stage requires "
                "--num-layers")
        if args.num_layers % args.num_layers_per_virtual_pipeline_stage:
            raise ValueError(
                "number of layers is not divisible by number of layers "
                "per virtual pipeline stage")
        args.virtual_pipeline_model_parallel_size = (
            (args.num_layers // args.pipeline_model_parallel_size)
            // args.num_layers_per_virtual_pipeline_stage)
    if (
        args.virtual_pipeline_model_parallel_size is not None
        and args.pipeline_model_parallel_size <= 2
    ):
        raise ValueError(
            "interleaved schedule requires pipeline size > 2"
        )
    if args.pipeline_model_parallel_split_rank is not None:
        if not (args.pipeline_model_parallel_split_rank
                < args.pipeline_model_parallel_size):
            raise ValueError(
                "split rank needs to be less than pipeline model parallel "
                f"size ({args.pipeline_model_parallel_size})")
    if args.recompute_method is not None and args.recompute_granularity != "full":
        raise ValueError(
            "--recompute-method is only meaningful with "
            "--recompute-granularity full"
        )
    if args.lr_warmup_fraction is not None and args.lr_warmup_iters != 0:
        raise ValueError(
            "can only specify one of --lr-warmup-fraction and "
            "--lr-warmup-iters"
        )
    if args.save_interval is not None and args.save is None:
        raise ValueError("--save-interval requires --save")
    return args


def _add_inference_args(parser):
    group = parser.add_argument_group(title="inference")
    group.add_argument("--inference-batch-times-seqlen-threshold", type=int,
                       default=512)
    return parser


def _add_network_size_args(parser):
    group = parser.add_argument_group(title="network size")
    group.add_argument("--num-layers", type=int, default=None)
    group.add_argument("--hidden-size", type=int, default=None)
    group.add_argument("--ffn-hidden-size", type=int, default=None)
    group.add_argument("--num-attention-heads", type=int, default=None)
    group.add_argument("--kv-channels", type=int, default=None)
    group.add_argument("--max-position-embeddings", type=int, default=None)
    group.add_argument("--layernorm-epsilon", type=float, default=1e-5)
    group.add_argument("--vocab-size", type=int, default=None)
    group.add_argument("--make-vocab-size-divisible-by", type=int, default=128)
    group.add_argument(
        "--apply-query-key-layer-scaling", action="store_true", default=True
    )
    group.add_argument("--apply-residual-connection-post-layernorm",
                       action="store_true")
    group.add_argument("--openai-gelu", action="store_true")
    group.add_argument("--onnx-safe", type=bool, default=None)
    group.add_argument("--num-experts", type=int, default=None,
                       help="Number of MoE experts (reference :395)")
    group.add_argument("--bert-binary-head", action="store_true", default=True)
    group.add_argument("--no-bert-binary-head", action="store_false",
                       dest="bert_binary_head")
    group.add_argument("--bert-no-binary-head", action="store_false",
                       dest="bert_binary_head",
                       help="the reference's spelling of the same toggle")
    return parser


def _add_logging_args(parser):
    group = parser.add_argument_group(title="logging")
    group.add_argument("--log-params-norm", action="store_true")
    group.add_argument("--log-num-zeros-in-grad", action="store_true")
    group.add_argument("--timing-log-level", type=int, default=0,
                       choices=range(0, 3))
    group.add_argument("--timing-log-option", type=str, default="minmax",
                       choices=["max", "minmax", "all"])
    group.add_argument("--tensorboard-dir", type=str, default=None)
    group.add_argument("--tensorboard-log-interval", type=int, default=1)
    group.add_argument("--tensorboard-queue-size", type=int, default=1000)
    group.add_argument("--log-timers-to-tensorboard", action="store_true")
    group.add_argument("--log-validation-ppl-to-tensorboard",
                       action="store_true")
    group.add_argument("--log-memory-to-tensorboard", action="store_true")
    group.add_argument("--log-batch-size-to-tensorboard", action="store_true")
    group.add_argument("--log-world-size-to-tensorboard", action="store_true")
    # the reference's (sic) spelling — command-line parity demands it
    group.add_argument("--no-log-learnig-rate-to-tensorboard",
                       action="store_false",
                       dest="log_learning_rate_to_tensorboard")
    group.add_argument("--no-log-loss-scale-to-tensorboard",
                       action="store_false",
                       dest="log_loss_scale_to_tensorboard")
    group.add_argument("--log-interval", type=int, default=100)
    return parser


def _add_regularization_args(parser):
    group = parser.add_argument_group(title="regularization")
    group.add_argument("--attention-dropout", type=float, default=0.1)
    group.add_argument("--hidden-dropout", type=float, default=0.1)
    group.add_argument("--weight-decay", type=float, default=0.01)
    group.add_argument("--start-weight-decay", type=float, default=None)
    group.add_argument("--end-weight-decay", type=float, default=None)
    group.add_argument("--weight-decay-incr-style", type=str,
                       default="constant",
                       choices=["constant", "linear", "cosine"])
    group.add_argument("--clip-grad", type=float, default=1.0)
    group.add_argument("--adam-beta1", type=float, default=0.9)
    group.add_argument("--adam-beta2", type=float, default=0.999)
    group.add_argument("--adam-eps", type=float, default=1e-8)
    group.add_argument("--sgd-momentum", type=float, default=0.9)
    return parser


def _add_training_args(parser):
    group = parser.add_argument_group(title="training")
    group.add_argument("--micro-batch-size", type=int, default=None)
    group.add_argument("--batch-size", type=int, default=None,
                       help="deprecated; use --micro-batch-size")
    group.add_argument("--global-batch-size", type=int, default=None)
    group.add_argument("--rampup-batch-size", nargs="*", default=None)
    group.add_argument("--train-iters", type=int, default=None)
    group.add_argument("--train-samples", type=int, default=None)
    group.add_argument("--exit-interval", type=int, default=None)
    group.add_argument("--exit-duration-in-mins", type=int, default=None)
    group.add_argument("--optimizer", type=str, default="adam",
                       choices=["adam", "sgd", "lamb"])
    group.add_argument(
        "--recompute-granularity", type=str, default=None,
        choices=["full", "selective"],
    )
    group.add_argument("--recompute-activations", action="store_true",
                       help="shorthand for --recompute-granularity "
                       "selective (reference :502)")
    group.add_argument("--distribute-saved-activations", action="store_true",
                       help="distribute recomputed activations across the "
                       "model parallel group (reference :513)")
    group.add_argument("--recompute-method", type=str, default=None,
                       choices=["uniform", "block"])
    group.add_argument("--recompute-num-layers", type=int, default=1)
    group.add_argument("--cpu-offload", action="store_true",
                       help="activation offload to pinned host memory")
    group.add_argument("--dataloader-type", type=str, default=None,
                       choices=["single", "cyclic"])
    group.add_argument("--no-async-tensor-model-parallel-allreduce",
                       action="store_false",
                       dest="async_tensor_model_parallel_allreduce")
    group.add_argument("--no-persist-layer-norm", action="store_true")
    group.add_argument("--sequence-parallel", action="store_true")
    group.add_argument("--no-gradient-accumulation-fusion",
                       action="store_false",
                       dest="gradient_accumulation_fusion")
    # fusion toggles of the reference's CUDA extensions, accepted and
    # ignored:
    group.add_argument("--no-masked-softmax-fusion", action="store_false",
                       dest="masked_softmax_fusion")
    group.add_argument("--no-bias-gelu-fusion", action="store_false",
                       dest="bias_gelu_fusion")
    group.add_argument("--no-bias-dropout-fusion", action="store_false",
                       dest="bias_dropout_fusion")
    group.add_argument("--empty-unused-memory-level", type=int, default=0,
                       choices=range(0, 3))
    group.add_argument("--checkpoint-activations", action="store_true",
                       help="deprecated; upgraded to --recompute-granularity "
                       "full --recompute-method uniform (reference :115-121)")
    return parser


def _add_initialization_args(parser):
    group = parser.add_argument_group(title="initialization")
    group.add_argument("--seed", type=int, default=1234)
    group.add_argument("--init-method-std", type=float, default=0.02)
    group.add_argument("--init-method-xavier-uniform", action="store_true")
    return parser


def _add_learning_rate_args(parser):
    group = parser.add_argument_group(title="learning rate")
    group.add_argument("--lr", type=float, default=None)
    group.add_argument("--lr-decay-style", type=str, default="linear",
                       choices=["constant", "linear", "cosine"])
    group.add_argument("--lr-decay-iters", type=int, default=None)
    group.add_argument("--lr-decay-samples", type=int, default=None)
    group.add_argument("--lr-warmup-fraction", type=float, default=None)
    group.add_argument("--lr-warmup-iters", type=int, default=0)
    group.add_argument("--lr-warmup-samples", type=int, default=0)
    group.add_argument("--warmup", type=int, default=None,
                       help="deprecated; use --lr-warmup-fraction")
    group.add_argument("--min-lr", type=float, default=0.0)
    group.add_argument("--override-lr-scheduler", action="store_true")
    group.add_argument("--use-checkpoint-lr-scheduler", action="store_true")
    return parser


def _add_checkpointing_args(parser):
    group = parser.add_argument_group(title="checkpointing")
    group.add_argument("--save", type=str, default=None)
    group.add_argument("--save-interval", type=int, default=None)
    group.add_argument("--no-save-optim", action="store_true", default=None)
    group.add_argument("--no-save-rng", action="store_true", default=None)
    group.add_argument("--load", type=str, default=None)
    group.add_argument("--no-load-optim", action="store_true", default=None)
    group.add_argument("--no-load-rng", action="store_true", default=None)
    group.add_argument("--finetune", action="store_true")
    return parser


def _add_mixed_precision_args(parser):
    group = parser.add_argument_group(title="mixed precision")
    group.add_argument("--fp16", action="store_true")
    group.add_argument("--bf16", action="store_true")
    group.add_argument("--loss-scale", type=float, default=None)
    group.add_argument("--initial-loss-scale", type=float, default=2 ** 32)
    group.add_argument("--min-loss-scale", type=float, default=1.0)
    group.add_argument("--loss-scale-window", type=float, default=1000)
    group.add_argument("--hysteresis", type=int, default=2)
    group.add_argument("--fp32-residual-connection", action="store_true")
    group.add_argument("--no-query-key-layer-scaling", action="store_false",
                       dest="apply_query_key_layer_scaling")
    group.add_argument("--attention-softmax-in-fp32", action="store_true")
    group.add_argument("--accumulate-allreduce-grads-in-fp32",
                       action="store_true", default=None)
    group.add_argument("--fp16-lm-cross-entropy", action="store_true")
    return parser


def _add_distributed_args(parser):
    group = parser.add_argument_group(title="distributed")
    group.add_argument("--tensor-model-parallel-size", type=int, default=1)
    group.add_argument("--pipeline-model-parallel-size", type=int, default=1)
    group.add_argument(
        "--virtual-pipeline-model-parallel-size", type=int, default=None
    )
    group.add_argument(
        "--pipeline-model-parallel-split-rank", type=int, default=None
    )
    group.add_argument("--model-parallel-size", type=int, default=None,
                       help="deprecated; use --tensor-model-parallel-size")
    group.add_argument("--num-layers-per-virtual-pipeline-stage", type=int,
                       default=None)
    group.add_argument("--no-contiguous-buffers-in-local-ddp",
                       action="store_false",
                       dest="use_contiguous_buffers_in_local_ddp")
    group.add_argument("--no-scatter-gather-tensors-in-pipeline",
                       action="store_false",
                       dest="scatter_gather_tensors_in_pipeline")
    group.add_argument("--local_rank", type=int, default=None,
                       dest="local_rank_underscore",
                       help="torch.distributed.launch spelling; folded into "
                       "--local-rank by validate_args")
    group.add_argument("--world-size", type=int, default=None)
    group.add_argument("--rank", type=int, default=0)
    group.add_argument("--local-rank", type=int, default=0)
    group.add_argument("--lazy-mpu-init", type=bool, default=None)
    # CUDA-only knobs accepted for command-line parity (ignored):
    group.add_argument("--DDP-impl", type=str, default="local",
                       choices=["local", "torch"])
    group.add_argument("--use-cpu-initialization", action="store_true",
                       default=None)
    group.add_argument("--distributed-backend", type=str, default="nccl",
                       choices=["nccl", "gloo", "ucc", "xla"])
    group.add_argument("--use-ring-exchange-p2p", action="store_true")
    group.add_argument("--standalone-embedding-stage", action="store_true")
    return parser


def _add_validation_args(parser):
    group = parser.add_argument_group(title="validation")
    group.add_argument("--eval-iters", type=int, default=100)
    group.add_argument("--eval-interval", type=int, default=1000)
    return parser


def _add_data_args(parser):
    group = parser.add_argument_group(title="data and dataloader")
    group.add_argument("--data-path", nargs="*", default=None)
    group.add_argument("--split", type=str, default="969, 30, 1")
    group.add_argument("--vocab-file", type=str, default=None)
    group.add_argument("--merge-file", type=str, default=None)
    group.add_argument("--seq-length", type=int, default=None)
    group.add_argument("--encoder-seq-length", type=int, default=None)
    group.add_argument("--decoder-seq-length", type=int, default=None)
    group.add_argument("--retriever-seq-length", type=int, default=256)
    group.add_argument("--mask-prob", type=float, default=0.15)
    group.add_argument("--short-seq-prob", type=float, default=0.1)
    group.add_argument("--mmap-warmup", action="store_true")
    group.add_argument("--num-workers", type=int, default=2)
    group.add_argument("--tokenizer-type", type=str, default=None,
                       choices=["BertWordPieceLowerCase",
                                "BertWordPieceCase", "GPT2BPETokenizer"])
    group.add_argument("--data-impl", type=str, default="infer",
                       choices=["lazy", "cached", "mmap", "infer"])
    group.add_argument("--vocab-extra-ids", type=int, default=0)
    group.add_argument("--sample-rate", type=float, default=1.0)
    group.add_argument("--reset-position-ids", action="store_true")
    group.add_argument("--reset-attention-mask", action="store_true")
    group.add_argument("--eod-mask-loss", action="store_true")
    return parser


def _add_autoresume_args(parser):
    group = parser.add_argument_group(title="autoresume")
    group.add_argument("--adlr-autoresume", action="store_true")
    group.add_argument("--adlr-autoresume-interval", type=int, default=1000)
    return parser


def _add_biencoder_args(parser):
    """Reference ``:854-909`` — ICT/REALM biencoder + retriever/indexer."""
    group = parser.add_argument_group(title="biencoder")
    group.add_argument("--ict-head-size", type=int, default=None)
    group.add_argument("--biencoder-projection-dim", type=int, default=0)
    group.add_argument("--biencoder-shared-query-context-model",
                       action="store_true")
    group.add_argument("--ict-load", type=str, default=None)
    group.add_argument("--bert-load", type=str, default=None)
    group.add_argument("--titles-data-path", type=str, default=None)
    group.add_argument("--query-in-block-prob", type=float, default=0.1)
    group.add_argument("--use-one-sent-docs", action="store_true")
    group.add_argument("--evidence-data-path", type=str, default=None)
    group.add_argument("--retriever-report-topk-accuracies", nargs="+",
                       type=int, default=[])
    group.add_argument("--retriever-score-scaling", action="store_true")
    group.add_argument("--block-data-path", type=str, default=None)
    group.add_argument("--embedding-path", type=str, default=None)
    group.add_argument("--indexer-batch-size", type=int, default=128)
    group.add_argument("--indexer-log-interval", type=int, default=1000)
    return parser


def _add_vision_args(parser):
    """Reference ``:911-977`` — ViT/Swin/MiT classification, inpainting,
    DINO self-supervision."""
    group = parser.add_argument_group(title="vision")
    group.add_argument("--num-classes", type=int, default=1000)
    group.add_argument("--img-h", type=int, default=224)
    group.add_argument("--img-w", type=int, default=224)
    group.add_argument("--num-channels", type=int, default=3)
    group.add_argument("--patch-dim", type=int, default=16)
    group.add_argument("--classes-fraction", type=float, default=1.0)
    group.add_argument("--data-per-class-fraction", type=float, default=1.0)
    group.add_argument("--no-data-sharding", action="store_false",
                       dest="data_sharding")
    group.add_argument("--head-lr-mult", type=float, default=1.0)
    group.add_argument("--vision-pretraining", action="store_true")
    group.add_argument("--vision-pretraining-type", type=str,
                       default="classify",
                       choices=["classify", "inpaint", "dino"])
    group.add_argument("--vision-backbone-type", type=str, default="vit",
                       choices=["vit", "mit", "swin"])
    group.add_argument("--swin-backbone-type", type=str, default="tiny",
                       choices=["tiny", "base", "h3"])
    group.add_argument("--mask-type", type=str, default="random",
                       choices=["random", "row"])
    group.add_argument("--mask-factor", type=float, default=1.0)
    group.add_argument("--iter-per-epoch", type=int, default=1250)
    group.add_argument("--dino-local-img-size", type=int, default=96)
    group.add_argument("--dino-local-crops-number", type=int, default=10)
    group.add_argument("--dino-head-hidden-size", type=int, default=2048)
    group.add_argument("--dino-bottleneck-size", type=int, default=256)
    group.add_argument("--dino-freeze-last-layer", type=float, default=1)
    group.add_argument("--dino-norm-last-layer", action="store_true")
    group.add_argument("--dino-warmup-teacher-temp", type=float, default=0.04)
    group.add_argument("--dino-teacher-temp", type=float, default=0.07)
    group.add_argument("--dino-warmup-teacher-temp-epochs", type=int,
                       default=30)
    return parser
