"""Configuration: settings persistence, CLI arguments, routing."""
from .settings import (SETTING_DEFAULTS, apply_setting_defaults,
                       dump_settings, dump_string_lists,
                       load_model_registry, load_settings,
                       load_string_lists, parse_model_registry,
                       parse_settings,
                       parse_string_lists, save_experiment_settings,
                       save_string_lists)

__all__ = ["SETTING_DEFAULTS", "apply_setting_defaults", "dump_settings",
           "dump_string_lists", "load_model_registry", "load_settings",
           "load_string_lists", "parse_model_registry", "parse_settings", "parse_string_lists",
           "save_experiment_settings", "save_string_lists"]
