"""Training losses (counterpart of nerftex_tpu/render/loss.py)."""

import torch

from nerftex_torch.utils import util


class NerfLoss:
    """Color loss, plus the coarse model's term when there is one."""

    def __init__(self, loss_fn: str = "network.loss.mse") -> None:
        self.loss = util.get_attr_from_path(loss_fn)

    def __call__(self, color_true, color_pred, color_pred_coarse=None, **kwargs):
        loss = self.loss(color_true, color_pred)
        if color_pred_coarse is not None:
            loss = loss + self.loss(color_true, color_pred_coarse)
        return loss


class AlphaLoss:
    """Color loss inside the alpha mask (hard: alpha > 0, or soft: alpha
    itself) plus gamma times the alpha loss, for the fine and coarse
    predictions."""

    def __init__(
        self,
        loss_fn: str = "network.loss.mse",
        alpha_loss_fn: str = None,
        gamma: float = 1.0,
        filter_color_loss: bool = True,
        use_hard_mask: bool = True,
    ) -> None:
        self.loss = util.get_attr_from_path(loss_fn)
        self.alpha_loss = (self.loss if alpha_loss_fn is None
                           else util.get_attr_from_path(alpha_loss_fn))
        self.gamma = gamma
        self.filter_color_loss = filter_color_loss
        self.use_hard_mask = use_hard_mask

    def __call__(self, color_true, alpha_true, color_pred, alpha_pred, color_pred_coarse=None,
                 alpha_pred_coarse=None, **kwargs):
        alpha_mask = None
        if self.filter_color_loss:
            if self.use_hard_mask:
                alpha_mask = (alpha_true[..., None] > 0).float()
            else:
                alpha_mask = alpha_true[..., None]
            color_true = color_true * alpha_mask
            color_pred = color_pred * alpha_mask

        loss = self.loss(color_true, color_pred)
        loss = loss + self.gamma * self.alpha_loss(alpha_true, alpha_pred)
        if color_pred_coarse is not None:
            if self.filter_color_loss:
                color_pred_coarse = color_pred_coarse * alpha_mask
            loss = loss + self.loss(color_true, color_pred_coarse)
            loss = loss + self.gamma * self.alpha_loss(alpha_true, alpha_pred_coarse)
        return loss


def mse(y_true, y_pred):
    """Mean squared error."""
    return torch.mean(torch.square(y_true - y_pred))


def smape(y_true, y_pred, eps: float = 1e-2):
    """Symmetric mean absolute percentage error."""
    return torch.mean(torch.abs(y_true - y_pred) / (y_true + y_pred + eps))
