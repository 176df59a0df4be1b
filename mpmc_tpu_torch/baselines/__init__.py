from mpmc_tpu_torch.baselines.classic import (  # noqa: F401
    run_feature_svm_baseline,
    run_majority_baseline,
    run_ngram_baseline,
    run_ngram_cv,
    run_ngram_fold_probs,
    run_random_baseline,
)
