"""The JAX package's configs as Python (the port needs no YAML parser).

``CONFIG`` is the sections of ``disentagled_multimodal_fusion_tpu/configs/config.yaml``
that the port reads (``tests/test_torch_serve.py`` holds it equal to the
YAML). ``SYNTHETIC_CONFIG`` is the whole of ``configs/synthetic_config.yaml``,
the synthetic dependence sweep's (``tests/test_torch_synthetic.py``), and
``LUMA_CONFIG`` the whole of ``configs/luma_config.yaml``, the LUMA
protocol's (``tests/test_torch_luma.py``). The
DisentangledSSL backbone's ``dssl.*`` keys have no section in either YAML,
so the code defaults apply (hidden 512, a 1.0, vmf, kappa 1.0, lr 1e-3).
"""

CONFIG = {
    "experiment": {
        "seeds": [0, 1, 2, 3, 4],
        "normal_datasets": ["CUB", "HandWritten", "PIE", "Scene"],
        "conflict_datasets": ["CUB", "HandWritten", "PIE", "Scene"],
    },
    "dataloader": {
        "batch_size": 100,
        "num_workers": 0,
    },
    "data": {
        "split": {"train_frac": 0.8},
        "conflict": {
            "addNoise": False,
            "sigma": 0.5,
            "ratio_noise": 0.0,
            "addConflict": True,
            "ratio_conflict": 1.0,
        },
    },
    "optim": {
        "dataset_lr": {
            "CalTech": 0.0003,
            "Scene": 0.01,
            "CUB": 0.003,
            "HandWritten": 0.003,
            "PIE": 0.003,
        },
    },
    "dmvae": {
        "dropout": 0,
        "a": 1.0e-5,
        "hidden_dim": 512,
        "embed_dim": 200,
        "lr": 0.0001,
        "num_epochs": 100,
    },
    "probes": {
        "dropout_p": 0.1,
        "annealing_start": 50,
        "model_epochs": 200,
        "model_hidden_dim": [128],
        "input_dim": 200,
    },
    "logging": {
        "datasets_excel_path": "logs/dataset_analysis.xlsx",
    },
}


_SYNTHETIC_COMMON = dict(n_samples=10000, d_signal=16)

SYNTHETIC_CONFIG = {
    "experiment": {
        "seeds": [0, 1, 2, 3, 4],
        "deps": [0, 25, 50, 75, 100],
    },
    "data": {
        # expected fused accuracy bands: easy 90-98%, med 70-90%, hard 55-75%
        "common_easy": dict(
            _SYNTHETIC_COMMON, d_spurious=4, alpha_shared=0.9, beta_specific=0.8,
            class_sep_shared=1.5, class_sep_private=1.3, noise_std=0.3, hetero_noise=False,
            hetero_scale=0.2, nonlinear_shared=False, nonlinear_specific=False,
            conflict_frac=0.1, conflict_strength=0.3,
        ),
        "common_med": dict(
            _SYNTHETIC_COMMON, d_spurious=16, alpha_shared=0.7, beta_specific=0.6,
            class_sep_shared=1.1, class_sep_private=0.9, noise_std=0.7, hetero_noise=True,
            hetero_scale=0.4, nonlinear_shared=True, nonlinear_specific=False,
            conflict_frac=0.4, conflict_strength=0.7,
        ),
        "common_hard": dict(
            _SYNTHETIC_COMMON, d_spurious=48, alpha_shared=0.5, beta_specific=0.4,
            class_sep_shared=0.8, class_sep_private=0.6, noise_std=1.2, hetero_noise=True,
            hetero_scale=0.6, nonlinear_shared=True, nonlinear_specific=True,
            conflict_frac=0.7, conflict_strength=0.9,
        ),
    },
    "dmvae": {
        "a": 1.0e-5,
        "hidden_dim": 512,
        "embed_dim": 16,
        "lr": 0.001,
        "output_dim": [32, 32],
        "num_epochs": 100,
    },
    "dmvae_fusion": {
        "annealing_start": 10,
        "lr": 0.0003,
        "num_classes": 3,
        "num_epochs": 50,
        "dropout": 0.1,
        "aggregation": "cml",
        "input_dim": 16,
        "hidden_dim": [128],
    },
    "latefusion": {
        "annealing_start": 10,
        "dropout": 0.1,
        "output_dims": [32, 32],
        "num_classes": 3,
        "hidden_dim": [128],
        "lr": 0.0003,
    },
    "logging": {
        "excel_path": "logs/synthetic_dataset.xlsx",
    },
}


LUMA_CONFIG = {
    "experiment": {"seeds": [0, 1, 2, 3, 4]},
    "data": {
        "luma_path": "data/luma_compiled",
        "audio": {"sample_rate": 16000, "max_length": 3.0, "n_mfcc": 40, "use_mfcc": True},
        "text": {"max_length": 128, "model_name": "bert-base-uncased", "use_pretrained": True},
        "image": {"size": [32, 32], "normalize": True},
    },
    "dataloader": {"batch_size": 64, "num_workers": 4},
    "optim": {"luma_lr": 0.0003},
    "dmvae": {
        "dropout": 0,
        "a": 1.0e-5,
        "hidden_dim": 512,
        "embed_dim": 200,
        "lr": 0.0001,
        "num_epochs": 3,  # the reference's debug override (run_luma.py:175)
    },
    "probes": {
        "dropout_p": 0.1,
        "annealing_start": 50,
        "model_epochs": 2,  # the reference's debug override (run_luma.py:162)
        "model_hidden_dim": [128],
        "input_dim": 200,
    },
}
