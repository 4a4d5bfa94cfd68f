"""UI translations (en/ja) — the i18n surface of the reference UIs
(web/translations/translation.json: 56 keys en/ja, loaded by
web/main.ts:41-60; python-legacy load_translations raw_photo_forge.py:1039).

Keys cover the slider/tab/button vocabulary; the server injects the chosen
locale's strings into the page.
"""

TRANSLATIONS = {
    "en": {
        "app_title": "RawPhotoForge-TPU",
        "exposure": "Exposure",
        "contrast": "Contrast",
        "shadow": "Shadow",
        "highlight": "Highlight",
        "black": "Black",
        "white": "White",
        "wb_temperature": "WB Temperature",
        "wb_tint": "WB Tint",
        "vignette": "Vignette",
        "lens_distortion": "Lens Distortion",
        "sharpness": "Sharpness",
        "mask_range": "Mask Range",
        "brightness": "Brightness",
        "hue": "Hue",
        "saturation": "Saturation",
        "lightness": "Lightness",
        "curve": "Curve",
        "reset": "Reset",
        "save_preset": "Save preset",
        "load_preset": "Load preset",
        "export_jpeg": "Export JPEG",
        "opening": "Processing on device\u2026",
        "histogram": "Histogram",
        "metadata": "Metadata",
        "masks": "Masks",
        "add_mask": "Add mask",
        "smart_select": "Smart select",
        "remove_mask": "Remove mask",
        "invert_mask": "Invert mask",
        "settings": "Settings",
        "preview_size": "Preview size",
        "drag_preview_size": "Drag preview size",
        "language": "Language",
        "crop": "Crop",
        "clear_crop": "Clear crop",
        "open_file": "Open image",
        "tab_tone": "Tone",
        "tab_wb": "WB",
        "tab_effect": "Effects",
        "reset_tab": "Reset this tab",
    },
    "ja": {
        "app_title": "RawPhotoForge-TPU",
        "exposure": "露出",
        "contrast": "コントラスト",
        "shadow": "シャドウ",
        "highlight": "ハイライト",
        "black": "ブラック",
        "white": "ホワイト",
        "wb_temperature": "色温度",
        "wb_tint": "色かぶり補正",
        "vignette": "周辺光量",
        "lens_distortion": "歪曲収差補正",
        "sharpness": "シャープネス",
        "mask_range": "マスク範囲",
        "brightness": "明るさ",
        "hue": "色相",
        "saturation": "彩度",
        "lightness": "輝度",
        "curve": "カーブ",
        "reset": "リセット",
        "save_preset": "プリセットを保存",
        "load_preset": "プリセットを読み込む",
        "export_jpeg": "JPEGを書き出す",
        "opening": "デバイスで処理中\u2026",
        "histogram": "ヒストグラム",
        "metadata": "メタデータ",
        "masks": "マスク",
        "add_mask": "マスクを追加",
        "smart_select": "スマート選択",
        "remove_mask": "マスクを削除",
        "invert_mask": "マスクを反転",
        "settings": "設定",
        "preview_size": "プレビューサイズ",
        "drag_preview_size": "ドラッグ時プレビューサイズ",
        "language": "言語",
        "crop": "切り抜き",
        "clear_crop": "切り抜きを解除",
        "open_file": "画像を開く",
        "tab_tone": "トーン",
        "tab_wb": "WB",
        "tab_effect": "効果",
        "reset_tab": "このタブをリセット",
    },
}

# EXIF field display names per locale (the reference shows Japanese tag
# names via photo_metadata.display_japanese when language is 日本語,
# raw_photo_forge.py:2017). Keys match io/dng._format_exif output;
# missing keys fall back to the raw field name.
EXIF_LABELS = {
    "en": {},
    "ja": {
        "Make": "メーカー",
        "Model": "機種名",
        "ExposureTime": "露出時間",
        "FNumber": "F値",
        "ISO": "ISO感度",
        "FocalLength": "焦点距離",
        "LensModel": "レンズモデル",
        "DateTime": "撮影日時",
    },
}


def exif_labels(locale: str) -> dict:
    return EXIF_LABELS.get(locale, EXIF_LABELS["en"])


def tr(locale: str) -> dict:
    return TRANSLATIONS.get(locale, TRANSLATIONS["en"])
