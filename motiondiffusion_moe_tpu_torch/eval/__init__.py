"""Evaluation: the contrastive evaluator, GloVe vectors, the metrics and
the replicated protocol (the JAX package's ``eval`` exports)."""

from motiondiffusion_moe_tpu_torch.eval.evaluator_models import (  # noqa: F401
    EvaluatorModelWrapper,
    MovementConvEncoder,
    TextEncoderBiGRUCo,
    MotionEncoderBiGRUCo,
    MotionLenEstimatorBiGRU,
    MaskedBiGRU,
    contrastive_loss,
    convert_torch_evaluator_checkpoint,
)
from motiondiffusion_moe_tpu_torch.eval.word_vectorizer import (  # noqa: F401
    POS_enumerator,
    WordVectorizer,
    HashedWordVectorizer,
    get_word_vectorizer,
)
from motiondiffusion_moe_tpu_torch.eval.protocol import (  # noqa: F401
    EvalSample,
    EvalBatch,
    ProtocolConfig,
    evaluation,
    evaluate_matching_score,
    evaluate_fid,
    evaluate_diversity,
    evaluate_multimodality,
    score_mae_velocity_jerk,
    build_generated_samples,
    build_generated_embeddings,
    evaluate_matching_score_from_embeddings,
    evaluate_multimodality_from_embeddings,
    make_batches,
    snap_length,
    snap_length_random,
)
from motiondiffusion_moe_tpu_torch.eval.metrics import (  # noqa: F401
    euclidean_distance_matrix,
    calculate_top_k,
    calculate_R_precision,
    calculate_matching_score,
    calculate_activation_statistics,
    calculate_diversity,
    calculate_multimodality,
    calculate_frechet_distance,
    get_metric_statistics,
)
