from sliders_tpu_torch.prompts.settings import (  # noqa: F401
    ACTION_TYPES,
    PromptSettings,
    load_prompts_from_yaml,
    slider_loss,
    slider_target,
)
