"""The port's ``TrainingRunConfig`` (dataclasses) against the JAX one
(pydantic v2, lax mode, ``extra="forbid"``): one table of YAML inputs, each
accepted or rejected by both, and where accepted the same values and the
same options from ``build_options``. Then one YAML directory with sibling
CSVs, subsample and weighting: equal options in both packages, and the
``env:`` block through ``apply_env``."""

import dataclasses
import os
import textwrap

import pytest

from mermaid_classifier_tpu.config.run_config import TrainingRunConfig as JConfig
from mermaid_classifier_tpu_torch.config.run_config import ConfigError
from mermaid_classifier_tpu_torch.config.run_config import TrainingRunConfig as TConfig

# (case id, YAML text).
CASES = [
    ("empty", ""),
    ("defaults", "dataset: {}\ntraining: {}\ntracking: {}\nenv: {}\n"),
    ("unknown_top", "not_a_real_block: {}\n"),
    ("unknown_dataset", "dataset: {include_mermiad: true}\n"),
    ("unknown_subsample", "dataset: {subsample: {total_annotations: 5, extra: 1}}\n"),
    ("unknown_weighting", "dataset: {weighting: {cap: 3}}\n"),
    ("unknown_training", "training: {epoch: 3}\n"),
    ("unknown_tracking", "tracking: {model: x}\n"),
    ("epochs_str", "training: {epochs: '10'}\n"),
    ("epochs_float_integral", "training: {epochs: 10.0}\n"),
    ("epochs_float_fraction", "training: {epochs: 10.5}\n"),
    ("epochs_str_fraction", "training: {epochs: '10.5'}\n"),
    ("epochs_str_zero_tail", "training: {epochs: '10.00'}\n"),
    ("epochs_str_underscore", "training: {epochs: '1_0'}\n"),
    ("epochs_str_exponent", "training: {epochs: '1e1'}\n"),
    ("epochs_str_spaces", "training: {epochs: ' 12 '}\n"),
    ("epochs_bool", "training: {epochs: true}\n"),
    ("epochs_null", "training: {epochs: null}\n"),
    ("epochs_list", "training: {epochs: [1]}\n"),
    ("patience_null", "training: {early_stopping_patience: null}\n"),
    ("patience_str", "training: {early_stopping_patience: '3'}\n"),
    ("total_missing", "dataset: {subsample: {strategy: balanced}}\n"),
    ("total_str", "dataset: {subsample: {total_annotations: '500'}}\n"),
    ("bool_yes", "training: {device_resident: 'yes'}\n"),
    ("bool_On", "training: {device_resident: 'On'}\n"),
    ("bool_F", "training: {device_resident: 'F'}\n"),
    ("bool_one", "training: {device_resident: 1}\n"),
    ("bool_two", "training: {device_resident: 2}\n"),
    ("bool_float_one", "training: {device_resident: 1.0}\n"),
    ("bool_half", "training: {device_resident: 0.5}\n"),
    ("bool_word", "training: {device_resident: 'sure'}\n"),
    ("bool_null", "dataset: {include_mermaid: null}\n"),
    ("str_int", "training: {resident_dtype: 16}\n"),
    ("str_bool", "tracking: {experiment_name: true}\n"),
    ("str_float", "tracking: {experiment_name: 1.5}\n"),
    ("str_null_optional", "tracking: {experiment_name: null}\n"),
    ("str_date", "dataset: {coralnet_manifest_uri: 2024-01-02}\n"),
    ("env_int", "env: {FOO: 1}\n"),
    ("env_bool", "env: {FOO: true}\n"),
    ("env_null", "env: {FOO: null}\n"),
    ("env_str", "env: {FOO: '1', BAR: baz}\n"),
    ("env_int_key", "env: {1: x}\n"),
    ("env_list", "env: [a]\n"),
    ("env_null_block", "env: null\n"),
    ("dataset_null", "dataset: null\n"),
    ("dataset_list", "dataset: [1]\n"),
    ("ratios_two", "dataset: {ref_val_ratios: [0.2, 0.1]}\n"),
    ("ratios_ints", "dataset: {ref_val_ratios: [0, 1]}\n"),
    ("ratios_strs", "dataset: {ref_val_ratios: ['0.2', '1e-1']}\n"),
    ("ratios_one", "dataset: {ref_val_ratios: [0.2]}\n"),
    ("ratios_three", "dataset: {ref_val_ratios: [0.2, 0.1, 0.1]}\n"),
    ("ratios_scalar", "dataset: {ref_val_ratios: 0.2}\n"),
    ("ratios_null_item", "dataset: {ref_val_ratios: [null, 0.1]}\n"),
    ("ratios_word", "dataset: {ref_val_ratios: [a, 0.1]}\n"),
    ("cap_str", "dataset: {weighting: {weight_ratio_cap: '5e3'}}\n"),
    ("cap_null", "dataset: {weighting: {weight_ratio_cap: null, enabled: false}}\n"),
    ("cap_inf", "dataset: {weighting: {weight_ratio_cap: .inf}}\n"),
    ("subsample_null", "dataset: {subsample: null, weighting: null}\n"),
    ("resident_bf16", "training: {resident_dtype: bfloat16}\n"),
    ("resident_bad", "training: {resident_dtype: float16}\n"),
    ("backend_device", "training: {calibration_backend: device}\n"),
    ("backend_bad", "training: {calibration_backend: gpu}\n"),
    ("method_temperature", "training: {calibration_method: temperature}\n"),
    ("method_bad", "training: {calibration_method: isotonic}\n"),
    ("model_name_ok", "tracking: {model_name: mermaid-mlp_v1.2}\n"),
    ("model_name_dash", "tracking: {model_name: -mlp}\n"),
    ("model_name_space", "tracking: {model_name: 'my model'}\n"),
    ("model_name_slash", "tracking: {model_name: a/b}\n"),
    ("config_dir_str", "config_dir: somewhere\n"),
    ("config_dir_int", "config_dir: 3\n"),
    ("top_list", "- a\n- b\n"),
]


def _load(cls, directory, text):
    path = directory / "training_config.yaml"
    path.write_text(text)
    try:
        return cls.from_yaml_path(path)
    except (ValueError, TypeError):
        return None


def _options(config):
    return [dataclasses.asdict(o) for o in config.build_options()]


@pytest.mark.parametrize("case", [c for c, _ in CASES])
def test_accepts_and_rejects_as_pydantic(tmp_path, case):
    text = dict(CASES)[case]
    jax_config = _load(JConfig, tmp_path, text)
    port_config = _load(TConfig, tmp_path, text)
    assert (port_config is None) == (jax_config is None), (
        case, "port accepted" if port_config else "port rejected")
    if jax_config is None:
        return
    jd = jax_config.model_dump()
    td = dataclasses.asdict(port_config)
    assert td == jd
    assert _options(port_config) == _options(jax_config)


def test_rejection_is_a_config_error(tmp_path):
    (tmp_path / "training_config.yaml").write_text("training: {epochs: 1.5}\n")
    with pytest.raises(ConfigError, match="epochs"):
        TConfig.from_yaml_path(tmp_path / "training_config.yaml")
    with pytest.raises(ConfigError, match="Extra inputs"):
        TConfig.from_mapping({"tracking": {"nme": "x"}})
    with pytest.raises(ConfigError, match="resident_dtype"):
        TConfig.from_mapping({"training": {"resident_dtype": "fp8"}})


FULL = textwrap.dedent("""\
    dataset:
      coralnet_manifest_uri: s3://bucket/manifest.parquet
      include_mermaid: true
      drop_growthforms: true
      label_rollup_spec_csv: rollups.csv
      included_labels_csv: {included}
      ref_val_ratios: [0.15, '0.05']
      subsample: {{strategy: balanced, total_annotations: '1_000', min_per_class: 20.0}}
      weighting: {{enabled: 'yes', weight_ratio_cap: 50}}
    training:
      epochs: 7
      early_stopping_patience: 2
      checkpoint_dir: /tmp/ckpt
      device_resident: on
      resident_dtype: int8
      calibration_backend: device
      calibration_method: temperature
    tracking:
      experiment_name: prod
      model_name: mermaid-mlp-prod
      extra_annotations_to_log: s12
    env:
      TORCH_RUN_CONFIG_TEST_FLAG: "on"
      OBJECT_STORE_ROOT: /data/store
    """)


def test_same_directory_gives_equal_options(tmp_path, monkeypatch):
    included = tmp_path / "elsewhere" / "included.csv"
    included.parent.mkdir()
    included.write_text("ba_id,gf_id\nba1,\n")
    (tmp_path / "rollups.csv").write_text("from_ba_id,from_gf_id,to_ba_id,to_gf_id\n")
    (tmp_path / "training_config.yaml").write_text(FULL.format(included=included))
    jax_config = JConfig.from_yaml_path(tmp_path / "training_config.yaml")
    port_config = TConfig.from_yaml_path(tmp_path / "training_config.yaml")
    assert port_config.config_dir == jax_config.config_dir == tmp_path.resolve()
    assert _options(port_config) == _options(jax_config)
    dataset, training, tracking = port_config.build_options()
    assert dataset.label_rollup_spec_csv == str(tmp_path.resolve() / "rollups.csv")
    assert dataset.included_labels_csv == str(included)
    assert dataset.subsample.total_annotations == 1000
    assert training.resident_dtype == "int8" and tracking.model_name == "mermaid-mlp-prod"

    monkeypatch.delenv("TORCH_RUN_CONFIG_TEST_FLAG", raising=False)
    monkeypatch.setenv("OBJECT_STORE_ROOT", "/before")
    port_config.apply_env()
    assert os.environ["TORCH_RUN_CONFIG_TEST_FLAG"] == "on"
    assert os.environ["OBJECT_STORE_ROOT"] == "/data/store"


def test_missing_sibling_csv_raises_in_both(tmp_path):
    (tmp_path / "training_config.yaml").write_text(
        "dataset: {label_rollup_spec_csv: nope.csv}\n")
    for cls in (JConfig, TConfig):
        config = cls.from_yaml_path(tmp_path / "training_config.yaml")
        with pytest.raises(FileNotFoundError, match="nope.csv"):
            config.build_options()
