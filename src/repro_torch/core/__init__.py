"""The paper's BIC core (:mod:`repro_torch.core.bic`)."""
